"""Linear autoencoder family (reference ``modules/movements/linear_ae/``;
the JAX package's ``models/movements/linear_ae.py``):

* ``LinearAE``: per-frame MLP autoencoder, sizes /2, /4, /8 of the input;
* ``LinearAE2D``: a 2D -> 2D autoencoder with a width scaling factor, for
  the autoencoder flow;
* ``LinearAEResidual`` / ``LinearAEResidualLeaky``: a residual bottleneck
  with BatchNorm and dropout 0.5, absolute (loc, rot) outputs; the leaky
  variant's slope is flax's 0.01.

Layers keep the flax names (``Dense_i``, ``BatchNorm_i``).
"""
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ...flows.output_types import MovementsModelOutputType
from ...ops.rotations import rotation_6d_to_matrix
from .common import (BatchNorm, FixedOutputModel, MovementsModel, dropout,
                     flax_dense, identity_head_init_, kaiming_normal_,
                     torch_dense_init_)


class LinearAE(MovementsModel):
    """Per-frame MLP autoencoder: hidden widths /2, /4, /8 of the input, then
    /4, /2 of the output, and the output head. Layers keep the JAX
    package's ``Dense_i`` names (``Dense_i.weight`` is the transpose of
    flax's ``Dense_i/kernel``). With ``identity_head`` (default) the head
    starts in the identity-rotation neighbourhood."""

    def __init__(self, identity_head: bool = True,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.identity_head = identity_head
        out_joints = len(self.output_nodes)
        in_size = len(self.input_nodes) * 2
        out_size = out_joints * self.output_features
        widths = (in_size // 2, in_size // 4, in_size // 8,
                  out_size // 4, out_size // 2, out_size)
        fan_in = in_size
        for i, width in enumerate(widths):
            self.add_module(f"Dense_{i}", nn.Linear(fan_in, width))
            fan_in = width
        self.num_layers = len(widths)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Seeded init: every layer ``nn.Linear``'s default, the head
        optionally the identity head."""
        for i in range(self.num_layers):
            layer = getattr(self, f"Dense_{i}")
            if self.identity_head and i == self.num_layers - 1:
                identity_head_init_(layer, self.movements_output_type,
                                    generator=generator)
            else:
                torch_dense_init_(layer, generator)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False):
        B, L = x.shape[:2]
        out_joints = len(self.output_nodes)
        h = x[..., :2].reshape(B * L, -1)
        for i in range(self.num_layers - 1):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        out = getattr(self, f"Dense_{self.num_layers - 1}")(h)
        return self.format_output(
            out.reshape(B, L, out_joints, self.output_features))


class LinearAE2D(FixedOutputModel):
    """Frame-independent 2D -> 2D autoencoder: widths 1024, 512, 256, 128,
    256, 512, 1024 over ``model_scaling_factor``, then the 2J head; ReLU
    between all but around the 128 bottleneck's output; ``nn.Linear``'s
    default init."""
    OUTPUT_TYPE = MovementsModelOutputType.pose_2d

    def __init__(self, model_scaling_factor: int = 8,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        s = model_scaling_factor
        widths = (1024 // s, 512 // s, 256 // s, 128 // s, 256 // s,
                  512 // s, 1024 // s, len(self.output_nodes) * 2)
        fan_in = len(self.input_nodes) * 2
        for i, width in enumerate(widths):
            layer = nn.Linear(fan_in, width)
            torch_dense_init_(layer, generator)
            self.add_module(f"Dense_{i}", layer)
            fan_in = width
        self.num_layers = len(widths)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False):
        B, L = x.shape[:2]
        h = x[..., :2].reshape(B * L, -1)
        for i in range(self.num_layers - 1):
            h = getattr(self, f"Dense_{i}")(h)
            if i != 3:                  # the bottleneck stays linear
                h = F.relu(h)
        out = getattr(self, f"Dense_{self.num_layers - 1}")(h)
        return out.reshape(B, L, len(self.output_nodes), 2)


class LinearAEResidual(FixedOutputModel):
    """Residual bottleneck autoencoder: Dense(ls), three Dense + BatchNorm
    + activation + dropout blocks down to ls/8, plus the bottleneck's
    residual branch Dense(ls/8) + BatchNorm + activation from the input,
    two blocks up to ls/2, Dense(ls), and the 9J head: absolute locations
    and 6D rotations. Dense kernels take flax's ``kaiming_normal``, biases
    0."""
    OUTPUT_TYPE = MovementsModelOutputType.absolute_loc_rot
    P_DROPOUT = 0.5

    @staticmethod
    def activation(x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)

    def __init__(self, linear_size: int = 256,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        ls = self.linear_size = linear_size
        in_size = len(self.input_nodes) * 2
        # (fan in, width, with BatchNorm) of Dense_0 .. Dense_8
        layers = ((in_size, ls, False), (ls, ls // 2, True),
                  (ls // 2, ls // 4, True), (ls // 4, ls // 8, True),
                  (in_size, ls // 8, True), (ls // 8, ls // 4, True),
                  (ls // 4, ls // 2, True), (ls // 2, ls, False),
                  (ls, len(self.output_nodes) * 9, False))
        norms = 0
        for i, (fan_in, width, norm) in enumerate(layers):
            self.add_module(f"Dense_{i}", flax_dense(
                fan_in, width, generator, kaiming_normal_))
            if norm:
                self.add_module(f"BatchNorm_{norms}", BatchNorm(width))
                norms += 1

    def _block(self, h, i, training, generator):
        """Dense_i, then BatchNorm_{i-1}, the activation and dropout."""
        h = getattr(self, f"BatchNorm_{i - 1}")(
            getattr(self, f"Dense_{i}")(h), training)
        return dropout(self.activation(h), self.P_DROPOUT, training,
                       generator)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L = x.shape[:2]
        flat = x[..., :2].reshape(B * L, -1)
        h = self.Dense_0(flat)
        for i in (1, 2, 3):
            h = self._block(h, i, training, generator)
        res = self.BatchNorm_3(self.Dense_4(flat), training)
        h = h + self.activation(res)
        for i in (5, 6):
            h = self._block(h, i, training, generator)
        out = self.Dense_8(self.Dense_7(h))
        out = out.reshape(B, L, len(self.output_nodes), 9)
        return out[..., :3], rotation_6d_to_matrix(out[..., 3:])


class LinearAEResidualLeaky(LinearAEResidual):
    """The leaky-ReLU variant (negative slope 0.01, flax's default)."""

    @staticmethod
    def activation(x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, 0.01)
