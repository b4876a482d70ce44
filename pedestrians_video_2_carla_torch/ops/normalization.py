"""Pose normalization: hips-neck, bbox and hips-neck-with-bbox-fallback
shift/scale extraction and (de)normalization, as pure functions on
tensors. Extractors return ``(shift (..., 2|3), scale (...))`` per frame;
callers thread them through."""
from typing import NamedTuple, Tuple, Type

import torch

from ..skeletons.base import Skeleton
from .tensors import device_constant, get_bboxes, nan_to_zero


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
    hips = sample[..., device_constant(skeleton.get_hips_indices(),
                                       sample.device), :].mean(dim=-2)
    neck = sample[..., device_constant(skeleton.get_neck_indices(),
                                       sample.device), :].mean(dim=-2)
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


#: the fallback's constants, measured on the CARLA reference skeletons
FALLBACK_X_SHIFT = 0.0
FALLBACK_Y_SHIFT = -0.1059
FALLBACK_SCALE = 0.5748


def hips_neck_bbox_fallback_shift_scale(sample: torch.Tensor,
                                        skeleton: Type[Skeleton],
                                        near_zero: float = 1e-5
                                        ) -> ShiftScale:
    """Hips-neck extraction, falling back to scaled-bbox estimates for the
    frames whose hips and/or neck are missing: the shift a fixed offset
    from the bbox centre, the scale a fixed fraction of the bbox's."""
    hn = hips_neck_shift_scale(sample, skeleton)
    neck = sample[..., device_constant(skeleton.get_neck_indices(),
                                       sample.device), :].mean(dim=-2)
    bb = bbox_shift_scale(sample, near_zero)

    missing_hips = torch.all(hn.shift < near_zero, dim=-1)
    missing_neck = torch.all(neck < near_zero, dim=-1)

    offset = device_constant((FALLBACK_X_SHIFT, FALLBACK_Y_SHIFT),
                             sample.device, sample.dtype)
    fb_shift = bb.shift + bb.scale[..., None] * offset
    shift = torch.where(missing_hips[..., None], fb_shift, hn.shift)
    scale = torch.where(missing_hips | missing_neck,
                        bb.scale * FALLBACK_SCALE, hn.scale)
    return ShiftScale(shift, scale)


EXTRACTORS = {
    "hips_neck": hips_neck_shift_scale,
    "hips_neck_bbox": hips_neck_bbox_fallback_shift_scale,
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
