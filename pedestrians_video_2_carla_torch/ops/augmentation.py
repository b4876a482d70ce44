"""Pose augmentation: random left/right flip and in-plane rotation with
exact inversion, written mask-based (``torch.where``) on batched tensors.

Flips permute joints by the skeleton's flip mask and mirror x around the
bbox centre (shifting bboxes as if the *image* was flipped when the clip
size is known); rotations spin around the bbox centre; missing joints
(exact zeros) stay zero; ``invert`` with the returned parameters restores
the original pose (rotation first, then the flip). The random draws come
from an explicit ``torch.Generator`` on the data's device.
"""
from typing import NamedTuple, Optional, Tuple, Type

import torch

from ..skeletons.base import Skeleton
from .tensors import device_constant, get_bboxes, get_missing_joints_mask


class AugmentParams(NamedTuple):
    is_flipped: torch.Tensor  # (B,) bool
    rotation: torch.Tensor    # (B,) degrees


def _centers(pose: torch.Tensor,
             bboxes: Optional[torch.Tensor]) -> torch.Tensor:
    if bboxes is None:
        bboxes = get_bboxes(pose[..., :2])
    return bboxes.mean(dim=-2, keepdim=True)  # (B, L, 1, 2)


def flip_pose(pose: torch.Tensor, is_flipped: torch.Tensor,
              skeleton: Type[Skeleton],
              bboxes: Optional[torch.Tensor] = None,
              clip_size: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Mirror selected clips left<->right.

    :param pose: (B, L, J, 2|3) pose (a confidence channel rides along).
    :param is_flipped: (B,) bool.
    :param clip_size: (B, 2) source video (width, height) or None.
    :return: (flipped pose, updated bboxes or None).
    """
    missing = ~get_missing_joints_mask(pose[..., :2])
    flip_mask = device_constant(skeleton.get_flip_mask(), pose.device)
    permuted = pose[..., flip_mask, :]
    selected = is_flipped[:, None, None, None]

    # mirror around the *original* bbox centre, then move to the centre the
    # bbox would have if the whole image had been flipped: x' = W - x when
    # the clip size is known
    centers = _centers(pose, bboxes)
    add_centers = centers
    new_bboxes = bboxes
    if bboxes is not None and clip_size is not None:
        half_w = clip_size[..., 0][..., None, None] / 2.0
        flipped_x = torch.flip(-(bboxes[..., 0] - half_w) + half_w, dims=(-1,))
        valid = torch.all(clip_size > 0)
        cand = torch.stack([flipped_x, bboxes[..., 1]], dim=-1)
        new_bboxes = torch.where(valid & selected, cand, bboxes)
        add_centers = torch.where(selected,
                                  new_bboxes.mean(dim=-2, keepdim=True),
                                  centers)

    flipped_x = -(permuted[..., 0] - centers[..., 0]) + add_centers[..., 0]
    flipped = torch.cat([flipped_x[..., None], permuted[..., 1:]], dim=-1)
    out = torch.where(selected, flipped, pose)
    out = torch.where(missing[..., None], torch.zeros_like(out), out)
    return out, new_bboxes


def _rotation_matrices(rotation_deg: torch.Tensor) -> torch.Tensor:
    rad = torch.deg2rad(rotation_deg)
    cos, sin = torch.cos(rad), torch.sin(rad)
    return torch.stack([torch.stack([cos, -sin], -1),
                        torch.stack([sin, cos], -1)], -2)  # (B, 2, 2)


def rotate_pose(pose: torch.Tensor, rotation_deg: torch.Tensor,
                bboxes: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Rotate each clip's 2D pose around its bbox centre.

    :param pose: (B, L, J, 2|3).
    :param rotation_deg: (B,) degrees.
    :return: (rotated pose, enlarged bboxes or None).
    """
    missing = ~get_missing_joints_mask(pose[..., :2])
    centers = _centers(pose, bboxes)
    rot = _rotation_matrices(rotation_deg)[:, None]  # (B, 1, 2, 2)

    coords = (pose[..., :2] - centers) @ rot + centers
    out = torch.cat([coords, pose[..., 2:]], dim=-1) \
        if pose.shape[-1] > 2 else coords
    out = torch.where(missing[..., None], torch.zeros_like(out), out)

    new_bboxes = bboxes
    if bboxes is not None:
        other = torch.stack([
            torch.stack([bboxes[..., 0, 0], bboxes[..., 1, 1]], -1),
            torch.stack([bboxes[..., 1, 0], bboxes[..., 0, 1]], -1)], -2)
        corners = (torch.cat([bboxes, other], dim=-2) - centers) @ rot \
            + centers
        new_bboxes = torch.stack(
            [corners.amin(dim=-2), corners.amax(dim=-2)], dim=-2)
    return out, new_bboxes


class AugmentPose:
    """Randomised flip + rotate with exact inversion. ``__call__`` draws
    from the given generator and returns the parameters it drew."""

    def __init__(self, nodes: Type[Skeleton], flip=False, rotate=False) -> None:
        self.nodes = nodes
        self.flip_prob = (flip if isinstance(flip, float) else 0.5) \
            if flip else 0.0
        self.max_rotation = (rotate if isinstance(rotate, float) else 10.0) \
            if rotate else 0.0

    def __call__(self, generator: torch.Generator, pose: torch.Tensor,
                 bboxes: Optional[torch.Tensor] = None,
                 clip_size: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            AugmentParams]:
        batch = pose.shape[0]
        kw = dict(generator=generator, device=pose.device)
        is_flipped = torch.rand((batch,), **kw) < self.flip_prob
        rotation = (torch.rand((batch,), dtype=pose.dtype, **kw) * 2.0
                    - 1.0) * self.max_rotation

        if bboxes is None:
            # bboxes are always tracked: the augmented bbox centre is the
            # anchor that makes ``invert`` exact
            bboxes = get_bboxes(pose[..., :2])
        out = pose
        if self.flip_prob > 0:
            out, bboxes = flip_pose(out, is_flipped, self.nodes, bboxes,
                                    clip_size)
        if self.max_rotation > 0:
            out, bboxes = rotate_pose(out, rotation, bboxes)
        return out, bboxes, AugmentParams(is_flipped, rotation)

    def invert(self, pose: torch.Tensor, params: AugmentParams,
               bboxes: Optional[torch.Tensor] = None,
               clip_size: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Undo the augmentation: the rotation first (negated), then the
        same flip. Pass the ``bboxes`` that ``__call__`` returned for an
        exact inversion: the rotated box's centre is the pre-rotation
        centre."""
        if bboxes is None:
            bboxes = get_bboxes(pose[..., :2])
        out = pose
        if self.max_rotation > 0:
            out, bboxes = rotate_pose(out, -params.rotation, bboxes)
        if self.flip_prob > 0:
            out, _ = flip_pose(out, params.is_flipped, self.nodes, bboxes,
                               clip_size)
        return out
