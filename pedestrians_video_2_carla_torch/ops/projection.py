"""Differentiable projection pipeline: model output -> 3D pose -> world
placement -> 2D screen projection, batched over (batch, frame).

``kernel="plain"`` is the JAX package's ``"xla"``: PyTorch ops on component
planes. ``kernel="fused"`` is its ``"pallas"``: the projections of the
pose_changes output with an identity world track go through the serving
CUDA kernel of ``ops/fused_projection.py``. ``kernel="fused_train"`` is its
``"pallas_train"``: on that same path the projections AND the absolute pose
locations come from the training kernels (forward and hand-written
backward), so the 2D and 3D losses' gradients both run through the backward
kernel. The other outputs (rotations, and for ``"fused"`` the absolute pose)
still come from the plane path, which runs eagerly here; under ``jit`` the
JAX package drops whatever the caller does not consume.
"""
from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..flows.output_types import (MovementsModelOutputType,
                                  TrajectoryModelOutputType)
from ..skeletons.carla import reference_poses_tensor
from . import camera as C
from . import kinematics as K
from .fused_projection import fused_projection, fused_projection_train
from .kinematics import _pack9, _unpack9
from .reference_skeletons import denormalize_from_abs

KERNELS = ("plain", "fused", "fused_train")


class ProjectionState(NamedTuple):
    """Per-batch constants of the projection."""
    rel_loc: torch.Tensor            # (B, 26, 3) reference relative locations
    rel_rot: torch.Tensor            # (B, 26, 3, 3) reference relative rotations
    age_gender_idx: torch.Tensor     # (B,) int index into AGE_GENDER_KEYS
    initial_world_loc: Optional[torch.Tensor] = None  # (B, 3)
    initial_world_rot: Optional[torch.Tensor] = None  # (B, 3, 3)


@lru_cache(maxsize=None)
def _reference_poses_on(device: torch.device):
    locs, rots = reference_poses_tensor()
    return (torch.as_tensor(locs, device=device),
            torch.as_tensor(rots, device=device))


def projection_state_for(age_gender_idx: torch.Tensor) -> ProjectionState:
    """Gather the per-clip reference skeletons for a batch of age/gender
    indices, on the indices' device."""
    locs, rots = _reference_poses_on(age_gender_idx.device)
    return ProjectionState(rel_loc=locs[age_gender_idx],
                           rel_rot=rots[age_gender_idx],
                           age_gender_idx=age_gender_idx)


class ProjectionModule:
    """Static-config projection pipeline; a stateless callable."""

    def __init__(self,
                 movements_output_type: MovementsModelOutputType =
                 MovementsModelOutputType.pose_changes,
                 trajectory_output_type: TrajectoryModelOutputType =
                 TrajectoryModelOutputType.changes,
                 camera: Optional[C.PinholeCamera] = None,
                 kernel: str = "plain") -> None:
        self.movements_output_type = movements_output_type
        self.trajectory_output_type = trajectory_output_type
        self.camera = camera if camera is not None else C.make_camera()
        if kernel not in KERNELS:
            raise ValueError(f"unknown projection kernel {kernel!r}; "
                             f"expected one of {KERNELS}")
        self.kernel = kernel

    def __call__(self,
                 state: ProjectionState,
                 pose_inputs: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
                 world_loc_inputs: Optional[torch.Tensor] = None,
                 world_rot_inputs: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns ``(projections (B, L, J, 3), outputs dict)``."""
        mot = self.movements_output_type

        relative_loc = relative_rot = absolute_rot = None
        abs_loc_planes = None
        if mot in (MovementsModelOutputType.pose_changes,
                   MovementsModelOutputType.relative_rot):
            if pose_inputs.ndim < 5:
                raise RuntimeError(
                    f"{mot.name} input must be (B, L, J, 3, 3) "
                    "rotation matrices")
            if pose_inputs.shape[2] != state.rel_loc.shape[1]:
                raise RuntimeError(
                    f"{mot.name} input has {pose_inputs.shape[2]} joints, "
                    f"skeleton has {state.rel_loc.shape[1]}")
            B, clip_length = pose_inputs.shape[:2]
            if mot == MovementsModelOutputType.pose_changes:
                rel9 = K.accumulate9(
                    _unpack9(pose_inputs), _unpack9(state.rel_rot[:, None]))
            else:
                rel9 = _unpack9(pose_inputs)
            loc_planes = tuple(
                state.rel_loc[:, None, :, i].expand(
                    B, clip_length, state.rel_loc.shape[1])
                for i in range(3))
            abs_loc_planes, abs_rot9 = K.fk_planes(loc_planes, rel9)
            relative_rot = pose_inputs \
                if mot == MovementsModelOutputType.relative_rot \
                else _pack9(rel9)
            absolute_rot = _pack9(abs_rot9)
            absolute_loc = torch.stack(abs_loc_planes, dim=-1)
            relative_loc = state.rel_loc[:, None].expand(
                (state.rel_loc.shape[0], clip_length)
                + tuple(state.rel_loc.shape[1:]))
        elif mot == MovementsModelOutputType.absolute_loc:
            if pose_inputs.ndim < 4:
                raise RuntimeError(
                    "absolute_loc input must be (B, L, J, 3) locations")
            absolute_loc = denormalize_from_abs(
                pose_inputs, state.age_gender_idx, autonormalize=True)
        elif mot == MovementsModelOutputType.absolute_loc_rot:
            if not isinstance(pose_inputs, tuple):
                raise RuntimeError(
                    "absolute_loc_rot input must be a (loc, rot) tuple")
            absolute_loc = denormalize_from_abs(
                pose_inputs[0], state.age_gender_idx, autonormalize=True)
            absolute_rot = pose_inputs[1]
        else:
            raise RuntimeError(f"unsupported output type {mot}")

        world_loc, world_rot = self._world(
            state, absolute_loc, world_loc_inputs, world_rot_inputs)
        # identity world track (no trajectory/world inputs): the projection
        # skips the world transform; the identity arrays still go into the
        # outputs dict
        identity_world = (
            self.trajectory_output_type == TrajectoryModelOutputType.changes
            and world_loc_inputs is None and world_rot_inputs is None
            and state.initial_world_loc is None
            and state.initial_world_rot is None)
        w_loc = None if identity_world else world_loc
        w_rot = None if identity_world else world_rot

        kernel_path = (identity_world
                       and mot == MovementsModelOutputType.pose_changes)
        if self.kernel == "fused_train" and kernel_path:
            # the kernel's abs_loc replaces the plane path's, so loc_3d's
            # gradient runs through the backward kernel as well
            projections, absolute_loc = fused_projection_train(
                pose_inputs, state.rel_loc, state.rel_rot, self.camera)
        elif self.kernel == "fused" and kernel_path:
            projections = fused_projection(
                pose_inputs, state.rel_loc, state.rel_rot, self.camera)
        elif abs_loc_planes is not None:
            sx, sy, vz = C.project_pose_planes(
                self.camera, abs_loc_planes, world_loc=w_loc, world_rot=w_rot)
            projections = torch.stack([sx, sy, vz], dim=-1)
        else:
            projections = C.project_pose(
                self.camera, absolute_loc, world_loc=w_loc, world_rot=w_rot)

        return projections, {
            "relative_pose_loc": relative_loc,
            "relative_pose_rot": relative_rot,
            "absolute_pose_loc": absolute_loc,
            "absolute_pose_rot": absolute_rot,
            "world_loc": world_loc,
            "world_rot": world_rot,
        }

    def _world(self, state: ProjectionState, absolute_loc,
               world_loc_inputs, world_rot_inputs):
        batch_size, clip_length = absolute_loc.shape[:2]
        if self.trajectory_output_type == TrajectoryModelOutputType.changes:
            return K.world_from_changes(
                (batch_size, clip_length), world_loc_inputs, world_rot_inputs,
                state.initial_world_loc, state.initial_world_rot,
                dtype=absolute_loc.dtype, device=absolute_loc.device)
        # loc_rot: direct per-frame world transforms
        if world_loc_inputs is None:
            world_loc_inputs = torch.zeros(
                (batch_size, clip_length, 3), dtype=absolute_loc.dtype,
                device=absolute_loc.device)
        if world_rot_inputs is None:
            world_rot_inputs = torch.eye(
                3, dtype=absolute_loc.dtype, device=absolute_loc.device
            ).expand(batch_size, clip_length, 3, 3)
        return world_loc_inputs, world_rot_inputs
