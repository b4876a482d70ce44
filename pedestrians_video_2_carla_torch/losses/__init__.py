"""Loss registry with dependency resolution (``loc_2d``, ``loc_3d`` and
``loc_2d_3d`` so far). Losses are pure functions of a ``LossContext``;
"loss not available" (a missing target key or a None tensor) is decided
from the batch's keys, before any arithmetic."""
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import torch

from ..ops.tensors import get_missing_joints_mask
from ..skeletons.base import (Skeleton, common_hips_index,
                              get_common_indices)


@dataclass
class LossContext:
    """Everything a loss primitive may need."""
    input_nodes: Type[Skeleton]
    output_nodes: Type[Skeleton]
    sliced: Dict[str, Any]            # flow outputs: projection_2d, pose_inputs, ...
    targets: Dict[str, Any]
    requirements: Dict[str, torch.Tensor] = field(default_factory=dict)
    mask_missing_joints: bool = True


def _masked_mse(pred: torch.Tensor, gt: torch.Tensor,
                mask: Optional[torch.Tensor], reduction: str = "mean"
                ) -> torch.Tensor:
    """MSE with an optional per-joint mask; ``mean`` averages over the
    unmasked elements."""
    sq = (pred - gt) ** 2
    if mask is None:
        return sq.mean() if reduction == "mean" else sq.sum()
    m = mask[..., None].to(sq.dtype)
    total = (sq * m).sum()
    if reduction == "sum":
        return total
    count = m.sum() * sq.shape[-1]
    return total / torch.clamp(count, min=1.0)


def loss_loc_2d(ctx: LossContext) -> Optional[torch.Tensor]:
    """MSE on 2D projections over common joints, with missing-joint masking;
    the transformed (normalized) space is preferred when available."""
    out_idx, in_idx = get_common_indices(ctx.input_nodes, ctx.output_nodes)
    if ctx.sliced.get("projection_2d_transformed") is not None \
            and ctx.targets.get("projection_2d_transformed") is not None:
        pred = ctx.sliced["projection_2d_transformed"][..., out_idx, 0:2]
        gt = ctx.targets["projection_2d_transformed"][..., in_idx, 0:2]
    elif ctx.sliced.get("projection_2d") is not None \
            and ctx.targets.get("projection_2d") is not None:
        pred = ctx.sliced["projection_2d"][..., out_idx, 0:2]
        gt = ctx.targets["projection_2d"][..., in_idx, 0:2]
    else:
        return None
    mask = None
    if ctx.mask_missing_joints:
        mask = get_missing_joints_mask(
            gt, common_hips_index(ctx.input_nodes, in_idx))
    return _masked_mse(pred, gt, mask)


def loss_loc_3d(ctx: LossContext) -> Optional[torch.Tensor]:
    """MSE on absolute 3D pose locations (unmasked)."""
    if ctx.sliced.get("absolute_pose_loc") is None \
            or ctx.targets.get("absolute_pose_loc") is None:
        return None
    out_idx, in_idx = get_common_indices(ctx.input_nodes, ctx.output_nodes)
    pred = ctx.sliced["absolute_pose_loc"][:, :, out_idx]
    gt = ctx.targets["absolute_pose_loc"][:, :, in_idx]
    return _masked_mse(pred, gt, None)


def _composite(names: Sequence[str]):
    def fn(ctx: LossContext) -> Optional[torch.Tensor]:
        try:
            parts = [ctx.requirements[n] for n in names]
        except KeyError:
            return None
        return sum(parts)
    return fn


class LossModes(Enum):
    """(callable, deps)."""
    loc_2d = (loss_loc_2d, ())
    loc_3d = (loss_loc_3d, ())
    loc_2d_3d = (_composite(("loc_2d", "loc_3d")), ("loc_2d", "loc_3d"))


def resolve_loss_modes(loss_modes: Sequence) -> List[LossModes]:
    """Prepend dependencies (deduplicated, order-preserving)."""
    requested = [LossModes[m] if isinstance(m, str) else m for m in loss_modes]
    ordered: List[LossModes] = []
    for mode in requested:
        for dep in mode.value[1]:
            ordered.append(LossModes[dep])
        ordered.append(mode)
    return list(dict.fromkeys(ordered))


def calculate_losses(loss_modes: Sequence[LossModes],
                     requested: Sequence[LossModes],
                     ctx: LossContext) -> Dict[str, torch.Tensor]:
    """Evaluate the resolved loss chain, stopping after the first requested
    loss that can be computed."""
    loss_dict: Dict[str, torch.Tensor] = {}
    for mode in loss_modes:
        fn, deps = mode.value
        ctx.requirements = {k: v for k, v in loss_dict.items() if k in deps}
        value = fn(ctx)
        if value is not None:
            loss_dict[mode.name] = value
            if mode in requested:
                break
    return loss_dict


def primary_loss(loss_dict: Dict[str, torch.Tensor],
                 requested: Sequence[LossModes]) -> Tuple[str, torch.Tensor]:
    """First requested loss present in the dict."""
    for mode in requested:
        if mode.name in loss_dict:
            return mode.name, loss_dict[mode.name]
    raise RuntimeError("Couldn't calculate any loss.")
