"""CARLA-skeleton forward kinematics on component planes.

Conventions (as in the JAX package and the reference): row-vector matrices,
P3D coordinates, ``abs_rot = rel_rot @ parent_abs_rot`` and
``abs_loc = rel_loc @ parent_abs_rot + parent_abs_loc``.

Rotations travel as nine (..., J) component planes (row-major), so every
3x3 composition is 27 elementwise multiply-adds in true float32 (no matmul,
so no TF32 on the card). The FK walks the tree level by level
(``TOPO_LEVELS``, 8 levels). The across-frame accumulation of rotation
changes is a sequential loop over the clip: the JAX package uses a
``lax.associative_scan`` there, so the two round in a different order and
agree to float32 rounding (about 1e-6 relative), not bit for bit.
"""
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..skeletons.carla import NUM_BONES, PARENTS
from .rotations import mm


def _unpack9(rot: torch.Tensor):
    """(..., 3, 3) -> tuple of 9 (...) component planes (row-major)."""
    return tuple(rot[..., i, j] for i in range(3) for j in range(3))


def _pack9(c) -> torch.Tensor:
    return torch.stack(c, dim=-1).reshape(c[0].shape + (3, 3))


def _compose9(a, b):
    """Row-vector composition ``b @ a`` on component planes."""
    return tuple(
        b[i * 3] * a[j] + b[i * 3 + 1] * a[3 + j] + b[i * 3 + 2] * a[6 + j]
        for i in range(3) for j in range(3))


@lru_cache(maxsize=None)
def _levels_for(parents: Tuple[int, ...], device: torch.device):
    """Static FK schedule for a skeleton on one device: bones grouped by
    depth, each level's parent positions *within the previous level*, and
    the permutation from the topological concatenation back to bone order."""
    p = np.asarray(parents, dtype=np.int64)
    depth = np.zeros(len(p), dtype=np.int64)
    for i, pi in enumerate(p):
        depth[i] = 0 if pi < 0 else depth[pi] + 1
    levels = [np.nonzero(depth == d)[0] for d in range(int(depth.max()) + 1)]
    parent_pos = [None]
    for d in range(1, len(levels)):
        prev_index = {int(b): i for i, b in enumerate(levels[d - 1])}
        parent_pos.append(np.asarray(
            [prev_index[int(p[b])] for b in levels[d]], dtype=np.int64))
    topo = np.concatenate(levels)
    inv = np.empty_like(topo)
    inv[topo] = np.arange(len(topo))

    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)
    return ([t(lv) for lv in levels], [t(pp) for pp in parent_pos], t(inv))


def fk_planes(loc, rot, parents: Optional[Tuple[int, ...]] = None):
    """Plane-level FK: ``loc`` = 3 (..., J) location planes, ``rot`` = 9
    (..., J) rotation planes -> (abs_loc planes, abs_rot planes)."""
    if parents is None:
        parents = tuple(int(p) for p in PARENTS)
    level_bones, level_parent_pos, inv_perm = _levels_for(
        tuple(int(p) for p in parents), loc[0].device)
    # a depth-d bone's parent sits at depth d-1, so each level gathers only
    # from the previous level; results are concatenated in topological order
    # and un-permuted once at the end
    prev_rot = tuple(c[..., level_bones[0]] for c in rot)
    prev_loc = tuple(c[..., level_bones[0]] for c in loc)
    out_rot = [prev_rot]
    out_loc = [prev_loc]
    for bones, parent_pos in zip(level_bones[1:], level_parent_pos[1:]):
        p_rot = [c[..., parent_pos] for c in prev_rot]
        p_loc = [c[..., parent_pos] for c in prev_loc]
        c_rot = [c[..., bones] for c in rot]
        c_loc = [c[..., bones] for c in loc]
        prev_rot = _compose9(p_rot, c_rot)  # rel @ parent
        prev_loc = (
            c_loc[0] * p_rot[0] + c_loc[1] * p_rot[3] + c_loc[2] * p_rot[6]
            + p_loc[0],
            c_loc[0] * p_rot[1] + c_loc[1] * p_rot[4] + c_loc[2] * p_rot[7]
            + p_loc[1],
            c_loc[0] * p_rot[2] + c_loc[1] * p_rot[5] + c_loc[2] * p_rot[8]
            + p_loc[2],
        )
        out_rot.append(prev_rot)
        out_loc.append(prev_loc)
    abs_rot = tuple(
        torch.cat([lv[i] for lv in out_rot], dim=-1)[..., inv_perm]
        for i in range(9))
    abs_loc = tuple(
        torch.cat([lv[i] for lv in out_loc], dim=-1)[..., inv_perm]
        for i in range(3))
    return abs_loc, abs_rot


def forward_kinematics(rel_loc: torch.Tensor, rel_rot: torch.Tensor,
                       parents: Optional[Tuple[int, ...]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative pose -> absolute pose.

    :param rel_loc: (..., 26, 3) relative bone locations.
    :param rel_rot: (..., 26, 3, 3) relative bone rotation matrices.
    :return: ``(abs_loc (..., 26, 3), abs_rot (..., 26, 3, 3))``.
    """
    num_bones = NUM_BONES if parents is None else len(parents)
    if rel_loc.shape[-2] != num_bones or rel_rot.shape[-3] != num_bones:
        raise ValueError(
            f"forward_kinematics expects {num_bones} bones, got "
            f"loc {tuple(rel_loc.shape)} / rot {tuple(rel_rot.shape)}")
    abs_loc, abs_rot = fk_planes(
        (rel_loc[..., 0], rel_loc[..., 1], rel_loc[..., 2]),
        _unpack9(rel_rot), parents)
    return torch.stack(abs_loc, dim=-1), _pack9(abs_rot)


def move(changes_matrix: torch.Tensor,
         prev_relative_rot: torch.Tensor) -> torch.Tensor:
    """Per-bone rotation changes applied to relative rotations:
    ``new_rel = change @ prev_rel``."""
    return mm(changes_matrix, prev_relative_rot)


def accumulate9(changes9, init9):
    """9 (B, L, J) change planes + 9 (B, 1, J) initial planes -> 9 (B, L, J)
    relative-rotation planes: frame t holds ``C_t @ ... @ C_0 @ R_init``.

    A sequential loop over the clip, ``state_t = C_t @ state_{t-1}`` with
    ``state_{-1} = R_init``: the same order of operations as the CUDA kernel.
    """
    state = tuple(init9)
    frames = []
    for t in range(changes9[0].shape[1]):
        state = _compose9(state, tuple(c[:, t:t + 1] for c in changes9))
        frames.append(state)
    return tuple(torch.cat([f[i] for f in frames], dim=1) for i in range(9))


def accumulate_pose_changes(pose_changes: torch.Tensor,
                            initial_rel_rot: torch.Tensor) -> torch.Tensor:
    """(B, L, 26, 3, 3) rotation changes + (B, 26, 3, 3) initial relative
    rotations -> (B, L, 26, 3, 3) per-frame relative rotations."""
    return _pack9(accumulate9(_unpack9(pose_changes),
                              _unpack9(initial_rel_rot[:, None])))


def relative_pose_over_clip(pose_changes: torch.Tensor,
                            rel_loc: torch.Tensor,
                            rel_rot: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pose-changes input -> per-frame (rel_rot, abs_loc, abs_rot).

    :param pose_changes: (B, L, 26, 3, 3)
    :param rel_loc: (B, 26, 3) reference skeleton relative locations.
    :param rel_rot: (B, 26, 3, 3) initial relative rotations.
    :return: (rel_rot_seq (B,L,26,3,3), abs_loc (B,L,26,3), abs_rot (B,L,26,3,3))
    """
    rel_rot_seq = accumulate_pose_changes(pose_changes, rel_rot)
    clip_length = pose_changes.shape[1]
    rel_loc_seq = rel_loc[:, None].expand(
        (rel_loc.shape[0], clip_length) + tuple(rel_loc.shape[1:]))
    abs_loc, abs_rot = forward_kinematics(rel_loc_seq, rel_rot_seq)
    return rel_rot_seq, abs_loc, abs_rot


def world_from_changes(clip_shape: Tuple[int, int],
                       world_loc_change: Optional[torch.Tensor] = None,
                       world_rot_change: Optional[torch.Tensor] = None,
                       initial_world_loc: Optional[torch.Tensor] = None,
                       initial_world_rot: Optional[torch.Tensor] = None,
                       dtype=torch.float32,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """World track over the clip: ``W_rot_t = W_rot_init @ C_0 @ ... @ C_t``
    and ``W_loc_t = W_loc_init + sum(dl)``. ``device`` places the identity
    defaults when no input tensor fixes it.

    :param clip_shape: (batch_size, clip_length).
    :return: (world_loc (B, L, 3), world_rot (B, L, 3, 3)).
    """
    batch_size, clip_length = clip_shape
    for t in (world_loc_change, world_rot_change, initial_world_loc,
              initial_world_rot):
        if t is not None:
            device = t.device
            break
    if initial_world_loc is None:
        initial_world_loc = torch.zeros((batch_size, 3), dtype=dtype,
                                        device=device)
    if initial_world_rot is None:
        initial_world_rot = torch.eye(3, dtype=dtype, device=device).expand(
            batch_size, 3, 3)

    if world_loc_change is None:
        world_loc = initial_world_loc[:, None].expand(batch_size, clip_length, 3)
    else:
        world_loc = initial_world_loc[:, None] + torch.cumsum(
            world_loc_change, dim=1)

    if world_rot_change is None:
        world_rot = initial_world_rot[:, None].expand(
            batch_size, clip_length, 3, 3)
    else:
        # right-multiplied running product, one frame at a time
        cum = [world_rot_change[:, 0]]
        for t in range(1, clip_length):
            cum.append(mm(cum[-1], world_rot_change[:, t]))
        world_rot = mm(initial_world_rot[:, None], torch.stack(cum, dim=1))
    return world_loc, world_rot
