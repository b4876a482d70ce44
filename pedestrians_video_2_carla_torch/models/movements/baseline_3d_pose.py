"""Martinez'17 "simple yet effective baseline" 2D->3D lifter, per frame (the
JAX package's ``models/movements/baseline_3d_pose.py``): Linear(2J -> 1024)
+ BatchNorm + ReLU + dropout, ``num_stage`` residual stages of two such
blocks, Linear(1024 -> 3J). ``Baseline3DPoseRot`` is the 6D-rotations
variant. Layers keep the flax names (``Dense_i``, ``BatchNorm_i``,
``_LinearBlock_i``); Dense kernels take flax's ``kaiming_normal`` init and
zero biases, BatchNorm flax's default momentum 0.99.
"""
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ...flows.output_types import MovementsModelOutputType
from ...ops.rotations import rotation_6d_to_matrix
from .common import (BatchNorm, FixedOutputModel, dropout, flax_dense,
                     kaiming_normal_)


def _dense(in_features, out_features, generator):
    return flax_dense(in_features, out_features, generator, kaiming_normal_)


class _LinearBlock(nn.Module):
    """Two Dense + BatchNorm + ReLU + dropout layers and a residual."""

    def __init__(self, linear_size: int, p_dropout: float,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.p_dropout = p_dropout
        for i in range(2):
            self.add_module(f"Dense_{i}", _dense(linear_size, linear_size,
                                                 generator))
            self.add_module(f"BatchNorm_{i}", BatchNorm(linear_size))

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        y = x
        for i in range(2):
            y = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(y),
                                                training)
            y = dropout(F.relu(y), self.p_dropout, training, generator)
        return x + y


class Baseline3DPose(FixedOutputModel):
    """Absolute joint locations (B, L, J, 3), frame by frame."""
    #: the raw per-joint features of the head
    OUT_FEATURES = 3

    def __init__(self, linear_size: int = 1024, num_stage: int = 2,
                 p_dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.linear_size, self.num_stage = linear_size, num_stage
        self.p_dropout = p_dropout
        self.Dense_0 = _dense(len(self.input_nodes) * 2, linear_size,
                              generator)
        self.BatchNorm_0 = BatchNorm(linear_size)
        for i in range(num_stage):
            self.add_module(f"_LinearBlock_{i}", _LinearBlock(
                linear_size, p_dropout, generator))
        self.Dense_1 = _dense(linear_size,
                              len(self.output_nodes) * self.OUT_FEATURES,
                              generator)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L = x.shape[:2]
        h = self.BatchNorm_0(self.Dense_0(x[..., :2].reshape(B * L, -1)),
                             training)
        h = dropout(F.relu(h), self.p_dropout, training, generator)
        for i in range(self.num_stage):
            h = getattr(self, f"_LinearBlock_{i}")(h, training, generator)
        out = self.Dense_1(h).reshape(B, L, len(self.output_nodes),
                                      self.OUT_FEATURES)
        return self._finalize(out)

    def _finalize(self, out):
        return out


class Baseline3DPoseRot(Baseline3DPose):
    """6D rotations per joint -> relative_rot matrices."""
    OUTPUT_TYPE = MovementsModelOutputType.relative_rot
    OUT_FEATURES = 6

    def _finalize(self, out):
        return rotation_6d_to_matrix(out)
