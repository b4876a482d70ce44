"""Loss registry with dependency resolution: the primitives ``loc_2d``
(and its alias ``common_loc_2d``), ``loc_3d``, ``rot_3d``,
``cum_pose_changes``, ``pose_changes`` and ``per_joint_loc_2d``, and the
composite sums of the JAX package's ``losses/__init__.py``. Losses are pure
functions of a ``LossContext``; "loss not available" (a missing target key
or a None tensor) is decided from the batch's keys, before any arithmetic.
``heatmaps`` is not ported yet (see ``ROADMAP.md``)."""
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ..ops.kinematics import _compose9, _unpack9
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
    loss_weights: Dict[str, float] = field(default_factory=dict)
    loss_params: Optional[Sequence[float]] = None
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


def loss_rot_3d(ctx: LossContext) -> Optional[torch.Tensor]:
    """MSE on absolute rotation matrices."""
    if ctx.sliced.get("absolute_pose_rot") is None \
            or ctx.targets.get("absolute_pose_rot") is None:
        return None
    out_idx, in_idx = get_common_indices(ctx.input_nodes, ctx.output_nodes)
    pred = ctx.sliced["absolute_pose_rot"][:, :, out_idx]
    gt = ctx.targets["absolute_pose_rot"][:, :, in_idx]
    return ((pred - gt) ** 2).mean()


def _rotation_changes(ctx: LossContext) -> Optional[torch.Tensor]:
    """The model's rotation-change matrices, or None where the output is
    no (B, L, J, 3, 3) rotation (absolute_loc or pose_2d outputs) or the
    batch has no ``pose_changes`` target."""
    pose_inputs = ctx.sliced.get("pose_inputs")
    if pose_inputs is None or isinstance(pose_inputs, tuple) \
            or ctx.targets.get("pose_changes") is None \
            or tuple(pose_inputs.shape[-2:]) != (3, 3):
        return None
    return pose_inputs


def _cumulate9(planes):
    """Running product over the frame axis (1), earlier frame @ later
    frame (right-multiplied), on the nine component planes."""
    out = [tuple(p[:, 0] for p in planes)]
    for t in range(1, planes[0].shape[1]):
        # _compose9(a, b) = b @ a: the running product times frame t
        out.append(_compose9(tuple(p[:, t] for p in planes), out[-1]))
    return tuple(torch.stack([frame[i] for frame in out], dim=1)
                 for i in range(9))


def loss_cum_pose_changes(ctx: LossContext) -> Optional[torch.Tensor]:
    """MSE on the rotation changes accumulated over the frames (the
    right-multiplied running product), on the nine component planes. The
    JAX package accumulates with an associative scan, so the two agree to
    float32 rounding."""
    pose_inputs = _rotation_changes(ctx)
    if pose_inputs is None:
        return None
    cum_pred = _cumulate9(_unpack9(pose_inputs))
    cum_gt = _cumulate9(_unpack9(ctx.targets["pose_changes"]))
    return sum(((p - g) ** 2).mean()
               for p, g in zip(cum_pred, cum_gt)) / 9.0


def loss_pose_changes(ctx: LossContext) -> Optional[torch.Tensor]:
    """Sum-reduced squared error on the change matrices."""
    pose_inputs = _rotation_changes(ctx)
    if pose_inputs is None:
        return None
    return ((pose_inputs - ctx.targets["pose_changes"]) ** 2).sum()


def _per_joint_weights(ctx: LossContext, in_idx, num_joints: int,
                       like: torch.Tensor) -> torch.Tensor:
    """``loss_params`` as one weight per common joint, taken at the common
    input indices (the weights are per input-skeleton node); ones without
    ``loss_params``."""
    if ctx.loss_params is None:
        return torch.ones(num_joints, dtype=like.dtype, device=like.device)
    w_full = np.asarray(list(ctx.loss_params), dtype=float)
    if isinstance(in_idx, slice):
        w_sel = w_full[in_idx]
    else:
        idx = np.asarray(list(in_idx))
        if len(w_full) <= idx.max():
            raise ValueError(
                f"--loss_params supplies {len(w_full)} per-joint weights "
                f"but the input skeleton's common joints reach index "
                f"{int(idx.max())} — provide one weight per "
                f"input-skeleton node")
        w_sel = w_full[idx]
    if len(w_sel) != num_joints:
        raise ValueError(
            f"--loss_params resolves to {len(w_sel)} weights for "
            f"{num_joints} common joints")
    return torch.as_tensor(w_sel, dtype=like.dtype, device=like.device)


def loss_per_joint_loc_2d(ctx: LossContext) -> Optional[torch.Tensor]:
    """Per-joint weighted sum of 2D MSEs: each joint's mean over its
    unmasked elements, times its weight from ``loss_params``."""
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
    weights = _per_joint_weights(ctx, in_idx, pred.shape[-2], pred)
    sq = (pred - gt) ** 2
    batch_dims = tuple(range(sq.ndim - 2)) + (sq.ndim - 1,)
    if ctx.mask_missing_joints:
        mask = get_missing_joints_mask(
            gt, common_hips_index(ctx.input_nodes, in_idx))
        m = mask[..., None].to(sq.dtype)
        counts = mask.to(sq.dtype).sum(dim=tuple(range(mask.ndim - 1))) \
            * sq.shape[-1]
        per_joint = (sq * m).sum(dim=batch_dims) / torch.clamp(counts,
                                                               min=1.0)
    else:
        per_joint = sq.mean(dim=batch_dims)
    return (per_joint * weights).sum()


def _composite(names: Sequence[str], weighted: bool = False):
    def fn(ctx: LossContext) -> Optional[torch.Tensor]:
        try:
            parts = [ctx.requirements[n] for n in names]
        except KeyError:
            return None
        if weighted:
            return sum(float(ctx.loss_weights.get(n, 1.0)) * p
                       for n, p in zip(names, parts))
        return sum(parts)
    return fn


class LossModes(Enum):
    """(callable, deps)."""
    loc_2d = (loss_loc_2d, ())
    common_loc_2d = (loss_loc_2d, ())  # the JAX CLI's alias of loc_2d
    loc_3d = (loss_loc_3d, ())
    rot_3d = (loss_rot_3d, ())
    cum_pose_changes = (loss_cum_pose_changes, ())
    pose_changes = (loss_pose_changes, ())
    loc_2d_3d = (_composite(("loc_2d", "loc_3d")), ("loc_2d", "loc_3d"))
    loc_2d_loc_rot_3d = (_composite(("loc_2d", "loc_3d", "rot_3d")),
                         ("loc_2d", "loc_3d", "rot_3d"))
    weighted_loc_2d_loc_rot_3d = (
        _composite(("loc_2d", "loc_3d", "rot_3d"), weighted=True),
        ("loc_2d", "loc_3d", "rot_3d"))
    loc_rot_3d = (_composite(("loc_3d", "rot_3d")), ("loc_3d", "rot_3d"))
    per_joint_loc_2d = (loss_per_joint_loc_2d, ())


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
