"""Small tensor utilities, written mask-based (no boolean indexing), so the
shapes never depend on the data."""
from functools import lru_cache
from typing import Optional, Sequence, Union

import numpy as np
import torch


@lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values: Union[Sequence, np.ndarray, slice],
                    device: torch.device,
                    dtype: torch.dtype = torch.int64):
    """A constant table (joint indices, per-joint probabilities) as a
    tensor on ``device``, made once per (table, dtype, device) and shared:
    callers never write to it. Building it from host values on every call
    would be a blocking host -> card copy each time. A ``slice`` index is
    returned as it is."""
    if isinstance(values, slice):
        return values
    return _constant(tuple(np.asarray(values).tolist()), dtype,
                     torch.device(device))


def get_bboxes(sample: torch.Tensor, near_zero: float = 1e-5) -> torch.Tensor:
    """Per-frame bounding boxes over the joint axis, ignoring missing points
    (ground truth ~0 means "not detected"). (..., J, C) -> (..., 2, C)
    stacked (min, max)."""
    missing = torch.all(sample[..., 0:2] < near_zero, dim=-1, keepdim=True)
    mins = sample.masked_fill(missing, float("inf")).amin(dim=-2)
    maxs = sample.masked_fill(missing, float("-inf")).amax(dim=-2)
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


def widen(x: torch.Tensor) -> torch.Tensor:
    """x in float32 if it is a half-precision float (bf16, fp16), else x
    itself: the dtype that flax's normalisation statistics and the bf16
    kernels' arithmetic use."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to bf16's values and kept float32, with the
    identity as its gradient: where a bf16 kernel rounds an operand or a
    stored intermediate, its plain version rounds the value and leaves the
    backward in float32."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def round_bf16x2(x: torch.Tensor) -> torch.Tensor:
    """x (float32) as the sum of two bf16 values, hi = bf16(x) and lo =
    bf16(x - hi) (16 significant bits), kept float32, with the identity as
    its gradient: the bf16 LSTM kernels' graph terms, a product operand in
    two bf16 parts."""
    hi = x.detach().to(torch.bfloat16).float()
    lo = (x.detach() - hi).to(torch.bfloat16).float()
    return x + (hi + lo - x).detach()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10 mantissa bits (ties away from zero,
    as the kernels' split of an operand rounds), kept float32, with the
    identity as its gradient: the bf16 scans' graph terms."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1fff).view(torch.float32)
    return x + (rounded.view_as(x) - x).detach()
