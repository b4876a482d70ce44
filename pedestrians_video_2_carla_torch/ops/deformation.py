"""Input deformation: additive noise + missing-joint dropout, drawn from an
explicit ``torch.Generator`` on the data's device."""
from typing import Optional, Sequence

import torch

from .tensors import device_constant


def add_noise(generator: torch.Generator, projection_2d: torch.Tensor,
              noise: str = "zero", noise_param: float = 1.0) -> torch.Tensor:
    """Additive gaussian/uniform noise on the (x, y) channels; a confidence
    channel (if present) is untouched."""
    coords = projection_2d[..., :2]
    if noise == "gaussian":
        coords = coords + noise_param * torch.randn(
            coords.shape, generator=generator, dtype=coords.dtype,
            device=coords.device)
    elif noise == "uniform":
        coords = coords + torch.rand(
            coords.shape, generator=generator, dtype=coords.dtype,
            device=coords.device) * noise_param - noise_param / 2.0
    elif noise not in ("zero", None, False):
        raise ValueError(f"Unknown noise type: {noise}")
    if projection_2d.shape[-1] > 2:
        return torch.cat([coords, projection_2d[..., 2:]], dim=-1)
    return coords


def drop_joints(generator: torch.Generator, projection_2d: torch.Tensor,
                missing_joint_probabilities: Sequence[float]) -> torch.Tensor:
    """Zero out joints with per-joint probabilities (missing-point encoding:
    exact zeros, including the confidence channel)."""
    probs = device_constant(missing_joint_probabilities,
                            projection_2d.device, projection_2d.dtype)
    u = torch.rand(projection_2d.shape[:-1], generator=generator,
                   dtype=projection_2d.dtype, device=projection_2d.device)
    missing = u < probs
    return torch.where(missing[..., None],
                       torch.zeros_like(projection_2d), projection_2d)


def deform(generator: torch.Generator, projection_2d: torch.Tensor,
           noise: str = "zero", noise_param: float = 1.0,
           missing_joint_probabilities: Optional[Sequence[float]] = None
           ) -> torch.Tensor:
    out = add_noise(generator, projection_2d, noise, noise_param)
    if missing_joint_probabilities is not None:
        out = drop_joints(generator, out, missing_joint_probabilities)
    return out
