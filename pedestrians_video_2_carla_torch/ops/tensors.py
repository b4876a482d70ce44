"""Small tensor utilities, written mask-based (no boolean indexing), so the
shapes never depend on the data."""
from typing import Optional

import torch


def get_bboxes(sample: torch.Tensor, near_zero: float = 1e-5) -> torch.Tensor:
    """Per-frame bounding boxes over the joint axis, ignoring missing points
    (ground truth ~0 means "not detected"). (..., J, C) -> (..., 2, C)
    stacked (min, max)."""
    missing = torch.all(sample[..., 0:2] < near_zero, dim=-1, keepdim=True)
    inf = torch.tensor(float("inf"), dtype=sample.dtype, device=sample.device)
    mins = torch.where(missing, inf, sample).amin(dim=-2)
    maxs = torch.where(missing, -inf, sample).amax(dim=-2)
    return torch.stack([mins, maxs], dim=-2)


def get_missing_joints_mask(common_gt: torch.Tensor,
                            hips_index: Optional[int] = None) -> torch.Tensor:
    """True where the joint is present. Missing joints are *exact* zeros in
    the ground truth; the hips joint is never masked.

    :param common_gt: (..., J, C) ground-truth points.
    :param hips_index: index of the hips joint within the common-joint axis,
        or None if hips are not among the common joints.
    """
    mask = torch.all(common_gt != 0, dim=-1)
    if hips_index is not None:
        mask = mask.clone()
        mask[..., hips_index] = True
    return mask


def nan_to_zero(sample: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(sample, nan=0.0, posinf=0.0, neginf=0.0)
