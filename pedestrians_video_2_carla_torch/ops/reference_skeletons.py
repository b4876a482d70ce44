"""Absolute poses of the four CARLA reference skeletons, their screen
projections, and denormalization onto them: of predicted 3D poses (the
``absolute_loc*`` movements outputs) and of normalized 2D poses (the
video logger's drawings)."""
from functools import lru_cache

import numpy as np
import torch

from ..skeletons.carla import CARLA_SKELETON, reference_poses_tensor
from . import camera as C
from . import kinematics as K
from . import normalization as N


@lru_cache(maxsize=None)
def reference_absolute_tensors():
    """FK of the four reference skeletons: float32 numpy
    ``(abs_loc (4, 26, 3), abs_rot (4, 26, 3, 3))``."""
    rel_loc, rel_rot = reference_poses_tensor()
    abs_loc, abs_rot = K.forward_kinematics(torch.from_numpy(rel_loc),
                                            torch.from_numpy(rel_rot))
    return abs_loc.numpy(), abs_rot.numpy()


@lru_cache(maxsize=None)
def reference_projections() -> np.ndarray:
    """Screen projections of the four reference skeletons, (4, 26, 3)
    float32 numpy (x, y in pixels, depth), seen by a camera at (3.1, 0, 0)
    looking at the origin (zero elevation)."""
    abs_loc, _ = reference_absolute_tensors()
    cam = C.make_camera(distance=3.1, shift=0.0, elevation=0.0,
                        look_at=(0.0, 0.0, 0.0))
    return C.project_pose(cam, torch.from_numpy(abs_loc)).numpy()


def _hips_neck_ss(reference: torch.Tensor, ndim_target: int) -> N.ShiftScale:
    ss = N.hips_neck_shift_scale(reference, CARLA_SKELETON)
    # broadcast (B, C)/(B,) reference shift/scale over the clip dimension
    while ss.shift.ndim < ndim_target - 1:
        ss = N.ShiftScale(ss.shift[:, None], ss.scale[:, None])
    return ss


def denormalize_from_projection(frames: torch.Tensor,
                                age_gender_idx: torch.Tensor) -> torch.Tensor:
    """Scale/shift normalized 2D poses onto the screen projection of each
    clip's reference skeleton.

    :param frames: (B, L, J, 2) normalized 2D pose coordinates.
    :param age_gender_idx: (B,) int index into AGE_GENDER_KEYS.
    """
    ref = torch.as_tensor(reference_projections()[..., :2],
                          device=frames.device)[age_gender_idx]
    return N.denormalize(frames, _hips_neck_ss(ref, frames.ndim), dim=2)


def denormalize_from_abs(frames: torch.Tensor,
                         age_gender_idx: torch.Tensor,
                         autonormalize: bool = False) -> torch.Tensor:
    """Scale/shift (optionally self-normalized) 3D poses onto the reference
    skeleton size of each clip's age/gender.

    :param frames: (B, L, J, 3) pose coordinates.
    :param age_gender_idx: (B,) int index into AGE_GENDER_KEYS.
    """
    if autonormalize:
        ss = N.hips_neck_shift_scale(frames, CARLA_SKELETON)
        frames = N.normalize(frames, ss, dim=3)
    ref = torch.as_tensor(reference_absolute_tensors()[0],
                          device=frames.device)[age_gender_idx]
    return N.denormalize(frames, _hips_neck_ss(ref, frames.ndim), dim=3)
