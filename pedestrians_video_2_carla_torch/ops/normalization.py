"""Pose normalization: hips-neck and bbox shift/scale extraction and
(de)normalization, as pure functions on tensors. Extractors return
``(shift (..., 2|3), scale (...))`` per frame; callers thread them through."""
from typing import NamedTuple, Tuple, Type

import torch

from ..skeletons.base import Skeleton
from .tensors import get_bboxes, nan_to_zero


class ShiftScale(NamedTuple):
    shift: torch.Tensor  # (..., C) per-frame shift point
    scale: torch.Tensor  # (...) per-frame scalar scale


def _safe_norm(v: torch.Tensor, dim: int = -1,
               eps: float = 1e-12) -> torch.Tensor:
    """L2 norm whose gradient is finite at exactly-zero vectors: the summed
    squares are clamped before the sqrt (``torch.linalg.norm`` gives NaN
    cotangents there). Values above sqrt(eps) are unchanged."""
    sq = (v * v).sum(dim)
    return torch.sqrt(torch.clamp(sq, min=eps))


def hips_neck_shift_scale(sample: torch.Tensor,
                          skeleton: Type[Skeleton]) -> ShiftScale:
    """Shift = hips point (mean over hips joints), scale = ||neck - hips||."""
    hips = sample[..., skeleton.get_hips_indices(), :].mean(dim=-2)
    neck = sample[..., skeleton.get_neck_indices(), :].mean(dim=-2)
    scale = _safe_norm(neck - hips, dim=-1)
    return ShiftScale(hips, scale)


def bbox_shift_scale(sample: torch.Tensor,
                     near_zero: float = 1e-5) -> ShiftScale:
    """Shift = bbox center, scale = ||top-center - center||."""
    bboxes = get_bboxes(sample, near_zero)
    center = bboxes.mean(dim=-2)
    top_center = torch.stack([center[..., 0], bboxes[..., 0, 1]], dim=-1)
    scale = _safe_norm(top_center - center, dim=-1)
    return ShiftScale(center, scale)


EXTRACTORS = {
    "hips_neck": hips_neck_shift_scale,
    "bbox": lambda sample, skeleton, **kw: bbox_shift_scale(sample, **kw),
}


def normalize(sample: torch.Tensor, shift_scale: ShiftScale, dim: int = 2,
              near_zero: float = 1e-5) -> torch.Tensor:
    """Shift/scale-normalize pose coordinates; a confidence channel (if any)
    is kept, and points with ~zero confidence are pinned to (0, 0)."""
    shift, scale = shift_scale
    # clamp degenerate scales: dividing by ~0 gives inf, whose nan_to_zero
    # has a NaN gradient; the clamped result is zeroed below anyway
    degenerate = scale < near_zero
    safe_scale = torch.where(degenerate, torch.ones_like(scale), scale)
    coords = (sample[..., 0:dim] - shift[..., None, :]) \
        / safe_scale[..., None, None]
    coords = torch.where(degenerate[..., None, None],
                         torch.zeros_like(coords), coords)
    coords = nan_to_zero(coords)
    if dim == 2 and sample.shape[-1] > 2:
        conf = sample[..., 2:]
        coords = torch.where(conf >= near_zero, coords,
                             torch.zeros_like(coords))
        return torch.cat([coords, conf], dim=-1)
    if sample.shape[-1] > dim:
        return torch.cat([coords, sample[..., dim:]], dim=-1)
    return coords


def denormalize(sample: torch.Tensor, shift_scale: ShiftScale,
                dim: int = 2) -> torch.Tensor:
    """Inverse of :func:`normalize`."""
    shift, scale = shift_scale
    coords = sample[..., 0:dim] * scale[..., None, None] + shift[..., None, :]
    if sample.shape[-1] > dim:
        return torch.cat([coords, sample[..., dim:]], dim=-1)
    return coords


def normalize_with(sample: torch.Tensor, skeleton: Type[Skeleton],
                   extractor: str = "hips_neck", dim: int = 2,
                   near_zero: float = 1e-5
                   ) -> Tuple[torch.Tensor, ShiftScale]:
    """Extract shift/scale from the first ``dim`` channels and normalize;
    returns ``(normalized, shift_scale)`` so callers can invert."""
    ss = EXTRACTORS[extractor](sample[..., 0:dim], skeleton)
    return normalize(sample, ss, dim=dim, near_zero=near_zero), ss
