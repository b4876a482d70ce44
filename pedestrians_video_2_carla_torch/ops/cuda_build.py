"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, and loaded with ``ctypes``. The
library goes into ``build/torch_kernels/`` beside the package, keyed by the
source's name and a hash of the source, the headers it includes from
``csrc/`` and the flags (an edited ``.cu`` or ``.cuh`` rebuilds). Nothing here runs when a module is imported.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ctypes argument types: device pointers and the stream as ``c_void_p``
#: (a plain int would be cut to 32 bits), sizes as ``c_int``
PTR, INT = ctypes.c_void_p, ctypes.c_int

#: loaded libraries, by source path
_loaded: Dict[Path, ctypes.CDLL] = {}

#: the kernel wrappers that count their launches, by name (:func:`counted`)
COUNTED: Dict[str, Callable] = {}


def nvcc() -> str:
    """nvcc of $CUDA_HOME (or $CUDA_PATH), else of $PATH, else of the
    toolkit's default install prefix."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels of csrc/")
    return path


def _local_headers(source: Path) -> List[Path]:
    """The headers beside ``source`` that it includes (``#include "x"``)."""
    names = re.findall(r'^\s*#\s*include\s+"([^"]+)"', source.read_text(),
                       re.MULTILINE)
    return [source.parent / name for name in names]


def library_path(source: Path) -> Path:
    """Where the library for ``source``, the headers it includes from its
    own directory and the current flags lives: an edited header rebuilds
    every source that includes it."""
    blob = b"".join([source.read_bytes()] + [
        h.read_bytes() for h in _local_headers(source)])
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build_library(source: Path) -> Path:
    """Compile ``source`` unless its build exists. The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside it as
    ``.log``. Raises on any failure."""
    path = library_path(source)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_library(source: Path, signatures: Dict[str, List]) -> ctypes.CDLL:
    """The library of ``source``, built at first use in this process (a
    launch then costs no hashing), with each C function of ``signatures``
    given its argument types; every one returns a CUDA error code."""
    if source not in _loaded:
        lib = ctypes.CDLL(str(build_library(source)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[source] = lib
    return _loaded[source]


def counted(name: str, wrapper: Callable, bf16: bool = False) -> None:
    """Register ``wrapper``, which adds one to its ``.launches`` (and, with
    ``bf16``, to ``.bf16_launches`` for a bf16 call) where it launches its
    kernel, as ``COUNTED[name]``, its counts at 0. Whoever reads or adjusts
    the counts (the resident epoch runner, ``chip_smoke.py``) reads
    ``COUNTED``."""
    wrapper.launches = 0
    if bf16:
        wrapper.bf16_launches = 0
    COUNTED[name] = wrapper


def check_launch(err: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error (a refused launch never
    runs, and a later synchronisation would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def check_cuda_tensors(fn_name: str, dtypes=(torch.float32,),
                       **tensors) -> torch.device:
    """A kernel takes contiguous tensors of ``dtypes`` (float32 unless
    given) on one CUDA device; returns that device."""
    device = next(iter(tensors.values())).device
    if device.type != "cuda":
        raise ValueError(f"{fn_name} needs CUDA tensors, got {device}")
    for name, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return device
