"""HDF5 subset IO in the JAX package's on-disk layout, bit for bit:
datasets ``projection_2d``, ``targets/*`` and ``meta/*``, with small string
metas label-encoded as uint16 plus a ``labels`` attribute. A subset written
by either package loads in the other. ``h5py`` is imported inside the two
functions."""
from typing import Any, Dict, Tuple

import numpy as np


def save_subset(path: str, projection_2d: np.ndarray,
                targets: Dict[str, np.ndarray],
                meta: Dict[str, Any]) -> int:
    import h5py

    # chunking needs data: a subset of 0 clips (test_set_frac=0) is stored
    # unchunked
    empty = len(projection_2d) == 0
    with h5py.File(path, "w") as f:
        f.create_dataset("projection_2d", data=projection_2d,
                         chunks=None if empty
                         else (1, *projection_2d.shape[1:]))
        for k, v in targets.items():
            v = np.asarray(v)
            f.create_dataset(f"targets/{k}", data=v,
                             chunks=(1, *v.shape[1:])
                             if v.ndim > 1 and len(v) else None)
        for k, v in meta.items():
            v_arr = np.asarray(v)
            if isinstance(v, np.ndarray) and v.dtype.kind not in ("U", "S", "O"):
                f.create_dataset(f"meta/{k}", data=v)
            elif v_arr.dtype.kind not in ("U", "S", "O"):
                f.create_dataset(f"meta/{k}", data=v_arr)
            else:
                unique = list(dict.fromkeys(str(s) for s in v))
                encoded = [s.encode("latin-1") for s in unique]
                max_len = max((len(s) for s in encoded), default=1)
                labels = np.array(encoded, dtype=h5py.string_dtype(
                    "ascii", max_len))
                if labels.nbytes < 64 * 1024:
                    mapping = {s: i for i, s in enumerate(unique)}
                    mapped = np.array([mapping[str(s)] for s in v],
                                      dtype=np.uint16)
                    ds = f.create_dataset(f"meta/{k}", data=mapped)
                    ds.attrs["labels"] = labels
                else:
                    enc = [str(s).encode("latin-1") for s in v]
                    max_v = max(len(s) for s in enc)
                    f.create_dataset(f"meta/{k}", data=np.array(
                        enc, dtype=h5py.string_dtype("ascii", max_v)))
    return len(projection_2d)


def load_subset(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray],
                                    Dict[str, Any]]:
    """A whole subset, read into memory: string metas decoded back to
    arrays of str."""
    import h5py

    targets: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    with h5py.File(path, "r") as f:
        projection_2d = f["projection_2d"][()]
        if "targets" in f:
            for k in f["targets"].keys():
                targets[k] = f[f"targets/{k}"][()]
        if "meta" in f:
            for k in f["meta"].keys():
                ds = f[f"meta/{k}"]
                values = ds[()]
                if "labels" in ds.attrs:
                    labels = [s.decode("latin-1") if isinstance(s, bytes)
                              else str(s) for s in ds.attrs["labels"]]
                    meta[k] = np.array([labels[i] for i in values])
                elif values.dtype.kind in ("S", "O"):
                    meta[k] = np.array([s.decode("latin-1") if
                                        isinstance(s, bytes) else str(s)
                                        for s in values])
                else:
                    meta[k] = values
    return projection_2d, targets, meta
