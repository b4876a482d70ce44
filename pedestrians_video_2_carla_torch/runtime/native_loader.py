"""ctypes bridge to the C++ batch loader and its flat binary subset cache.

A subset (projection_2d and its numeric targets) is rendered once into a
flat ``.bin`` (the arrays back to back, C-contiguous) with a JSON sidecar
of their offsets, dtypes and shapes; batches are then assembled by the
loader's multi-threaded gather straight out of the page cache. The format
is the JAX package's (``pv2c-bin-v1``): either package reads the other's
cache.

The library is built from ``native/batch_loader.cpp`` with ``g++`` at first
use into ``build/native/`` beside the package, keyed by a hash of the
source and the flags. Where it cannot be built,
:func:`native_loader_available` is false after one warning, and the
datamodules slice their batches with numpy (the same values).
"""
import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "batch_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")
_BUILD_LOCK = threading.Lock()
#: the loaded library; False once a build has failed
_LIB = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libbatch_loader-{digest[:16]}.so"


def _build(path: Path) -> None:
    """g++ into a temporary name, then renamed into place: processes that
    build at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE), "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_library():
    global _LIB
    if _LIB is not None:
        return _LIB or None
    with _BUILD_LOCK:
        if _LIB is not None:
            return _LIB or None
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            warnings.warn(f"the native batch loader could not be built "
                          f"({e!r} {detail.decode(errors='replace')[:500]}); "
                          f"batches are sliced with numpy")
            _LIB = False
            return None
        lib.bl_open.restype = ctypes.c_void_p
        lib.bl_open.argtypes = [ctypes.c_char_p]
        lib.bl_close.argtypes = [ctypes.c_void_p]
        lib.bl_gather.restype = ctypes.c_int
        lib.bl_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int]
        _LIB = lib
    return _LIB


def native_loader_available() -> bool:
    """Whether the library is built (building it at the first call)."""
    return _load_library() is not None


class BinarySubsetCache:
    """Flat binary cache of named arrays sharing a leading (clip) axis."""

    MAGIC = "pv2c-bin-v1"

    def __init__(self, path: str):
        self.path = path
        with open(path + ".json") as f:
            self.manifest = json.load(f)
        if self.manifest.get("magic") != self.MAGIC:
            raise ValueError(f"{path}.json is not a {self.MAGIC} manifest")
        self._lib = _load_library()
        if self._lib is None:
            raise RuntimeError("the native batch loader is unavailable "
                               "(its g++ build failed)")
        self._handle = self._lib.bl_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot map {path}")
        self.num_clips = self.manifest["num_clips"]
        self.arrays = self.manifest["arrays"]

    @classmethod
    def write(cls, path: str, arrays: Dict[str, np.ndarray]
              ) -> "BinarySubsetCache":
        """Render ``arrays`` (equal first axes) into ``path`` and its
        ``.json`` sidecar; returns the opened cache."""
        num_clips = None
        manifest: Dict = {"magic": cls.MAGIC, "arrays": {}}
        offset = 0
        with open(path, "wb") as f:
            for name, arr in arrays.items():
                arr = np.ascontiguousarray(arr)
                if num_clips is None:
                    num_clips = len(arr)
                if len(arr) != num_clips:
                    raise ValueError(f"{name}: {len(arr)} rows, expected "
                                     f"{num_clips}")
                manifest["arrays"][name] = {
                    "offset": offset,
                    "dtype": str(arr.dtype),
                    "shape": list(arr.shape[1:]),
                    "row_bytes": int(arr.nbytes // len(arr))
                    if len(arr) else 0,
                }
                f.write(arr.tobytes())
                offset += arr.nbytes
        manifest["num_clips"] = int(num_clips or 0)
        with open(path + ".json", "w") as f:
            json.dump(manifest, f)
        return cls(path)

    def gather(self, indices: Sequence[int],
               names: Optional[List[str]] = None,
               num_threads: Optional[int] = None) -> Dict[str, np.ndarray]:
        """A batch, ``{name: (len(indices), *shape) array}``; an index
        outside ``[0, num_clips)`` raises ``IndexError``."""
        if num_threads is None:
            num_threads = min(8, os.cpu_count() or 1)
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        if len(idx) and (idx.min() < 0 or idx.max() >= self.num_clips):
            raise IndexError(f"indices outside [0, {self.num_clips}) of "
                             f"{self.path}")
        out: Dict[str, np.ndarray] = {}
        for name in (names or self.arrays.keys()):
            info = self.arrays[name]
            arr = np.empty((len(idx),) + tuple(info["shape"]),
                           dtype=np.dtype(info["dtype"]))
            rc = self._lib.bl_gather(
                self._handle,
                ctypes.c_uint64(info["offset"]),
                ctypes.c_uint64(info["row_bytes"]),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int64(len(idx)),
                arr.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int(num_threads))
            if rc != 0:
                raise IndexError(f"native gather failed for {name}")
            out[name] = arr
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.bl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
