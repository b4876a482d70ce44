"""Trajectory model base + Zero implementation."""
from typing import Type

import torch
from torch import nn

from ...flows.output_types import TrajectoryModelOutputType
from ...skeletons.base import Skeleton
from ...skeletons.carla import CARLA_SKELETON


class TrajectoryModel(nn.Module):
    needs_targets = False

    def __init__(self, input_nodes: Type[Skeleton] = CARLA_SKELETON) -> None:
        super().__init__()
        self.input_nodes = input_nodes

    @property
    def output_type(self) -> TrajectoryModelOutputType:
        return TrajectoryModelOutputType.changes


class ZeroTrajectory(TrajectoryModel):
    """No in-world movement: zero location changes + identity rotations.
    ``is_zero`` lets flows skip the world track altogether. The ``dummy``
    parameter mirrors the JAX package's parameter tree."""
    is_zero = True

    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self.dummy = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, targets=None, training: bool = False):
        B, L = x.shape[:2]
        world_loc = torch.zeros((B, L, 3), dtype=x.dtype, device=x.device)
        world_rot = torch.eye(3, dtype=x.dtype, device=x.device).expand(
            B, L, 3, 3)
        return world_loc, world_rot
