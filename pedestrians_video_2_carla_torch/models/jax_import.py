"""Weight bridge: flax parameter trees (nested dicts of numpy arrays, as the
JAX package's flows hold them) -> the port's ``state_dict``s.

The mirror image of the JAX package's ``models/torch_import.py``: a flax
``Dense_i/kernel`` of shape (in, out) becomes ``Dense_i.weight`` of shape
(out, in), ``Dense_i/bias`` becomes ``Dense_i.bias``, and any other leaf
keeps its dotted path.
"""
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def flax_to_state_dict(tree: Mapping[str, Any], prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """Flatten a flax parameter tree into a PyTorch ``state_dict`` (CPU)."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(flax_to_state_dict(value, prefix=f"{path}."))
        elif name == "kernel":
            kernel = np.asarray(value)
            if kernel.ndim != 2:
                raise ValueError(f"{path}: only Dense kernels (2-D) are "
                                 f"bridged, got shape {kernel.shape}")
            out[f"{prefix}weight"] = torch.from_numpy(kernel.T.copy())
        else:
            out[path] = torch.from_numpy(np.array(value))
    return out


def import_linear_ae(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``LinearAE`` tree (``Dense_0`` .. ``Dense_5``) -> the port's
    ``LinearAE`` state_dict."""
    names = sorted(flax_params, key=lambda n: int(n.split("_")[1]))
    if names != [f"Dense_{i}" for i in range(len(names))]:
        raise ValueError(f"not a LinearAE parameter tree: {sorted(flax_params)}")
    return flax_to_state_dict(flax_params)


def import_flow_params(flax_params: Mapping[str, Any],
                       device: DeviceLike = None
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX flow's ``state.params`` ``{"movements": ..., "trajectory":
    ...}`` -> the port's flow parameter dict, on ``device`` (the card unless
    asked otherwise)."""
    device = resolve_device(device)
    return {name: {k: v.to(device) for k, v in
                   flax_to_state_dict(tree).items()}
            for name, tree in flax_params.items()}
