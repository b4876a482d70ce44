"""Pose-estimation base and the Linear baseline (the JAX package's
``models/pose_estimation/linear.py``). Inputs are clips of frames, (B, L,
3, H, W), channel-first."""
from typing import Optional, Sequence, Type

import torch
from torch import nn

from ...flows.output_types import PoseEstimationModelOutputType
from ...skeletons.base import Skeleton
from ...skeletons.carla import CARLA_SKELETON
from ..movements.common import lecun_normal_


class PoseEstimationModel(nn.Module):
    """Base of the pose-estimation models: skeleton config and the flow's
    flags."""
    needs_graph = False
    needs_heatmaps = False
    needs_targets = False

    def __init__(self, input_nodes: Type[Skeleton] = CARLA_SKELETON,
                 output_nodes: Type[Skeleton] = CARLA_SKELETON,
                 needs_confidence: bool = False) -> None:
        super().__init__()
        self.input_nodes = input_nodes
        self.output_nodes = output_nodes
        self.needs_confidence = needs_confidence

    @property
    def output_type(self) -> PoseEstimationModelOutputType:
        return PoseEstimationModelOutputType.pose_2d

    @property
    def eval_slice(self):
        return slice(None)

    @classmethod
    def supported_output_types(cls):
        return [PoseEstimationModelOutputType.pose_2d]


class Linear(PoseEstimationModel):
    """One dense layer (``Dense_0``, flax's init) from each flattened frame
    of ``video_size`` (H, W) to the 2D joints. The frame is flattened in
    flax's (H, W, C) order, so that a flax kernel imports as its
    transpose."""

    def __init__(self, video_size: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        h, w = video_size
        self.Dense_0 = nn.Linear(h * w * 3, len(self.output_nodes) * 2)
        lecun_normal_(self.Dense_0.weight, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False):
        B, L = x.shape[:2]
        h = x.permute(0, 1, 3, 4, 2).reshape(B, L, -1)
        return self.Dense_0(h).reshape(B, L, len(self.output_nodes), 2)
