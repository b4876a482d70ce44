"""VideoPose3D-style dilated temporal-convolution 2D->3D lifter (BASELINE
config 4; the JAX package's ``models/movements/video_pose_3d.py``): temporal
convolutions with exponentially dilated filters (receptive field =
prod(filter_widths), 3^4 = 81 by default), 1024 channels, residual blocks
of BatchNorm + ReLU + dropout. The input is edge-padded by rf // 2 frames a
side, so every frame gets a prediction and no eval slice is needed.

Each convolution is VALID and dilated, written as ``width`` shifted-slice
products ``y = sum_i x[:, i d : i d + L'] @ W_i``, as the JAX package's
``_TemporalConv``: dense fp32 ``torch.matmul``s, so no cuDNN convolution
(whose default in torch is TF32) enters the port. Parameters keep the flax
names (``expand_conv``, ``BatchNorm_k``, ``layer{i}_conv{1,2}``,
``shrink``); a conv's ``weight`` is in Conv1d's (out, in, width) layout.
"""
import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .common import (BatchNorm, FixedOutputModel, _uniform_, dropout,
                     torch_dense_init_)

#: the BatchNorm momentum of the public TemporalModel (torch's 0.1)
BN_MOMENTUM = 0.9


class TemporalConv(nn.Module):
    """A VALID dilated temporal conv over axis 1 of (B, L, C), no bias;
    ``weight`` (out, in, width), initialised as ``nn.Conv1d``'s default
    (U(+-1/sqrt(width * in)), as the JAX ``_TemporalConv``)."""

    def __init__(self, in_features: int, features: int, width: int,
                 dilation: int = 1,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.width, self.dilation = width, dilation
        self.weight = nn.Parameter(torch.empty(features, in_features, width))
        _uniform_(self.weight, 1.0 / math.sqrt(width * in_features),
                  generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        kernel = self.weight.permute(2, 1, 0).contiguous()  # (w, in, out)
        out_len = L - self.dilation * (self.width - 1)
        # each shifted slice as one (B L', in) @ (in, out) product: a 3-D
        # slice against a 2-D weight would let torch.matmul broadcast the
        # weight over the batch and copy it B times
        return sum(x[:, i * self.dilation:i * self.dilation + out_len]
                   .reshape(-1, C) @ kernel[i]
                   for i in range(self.width)).reshape(B, out_len, -1)


class VideoPose3D(FixedOutputModel):
    """Absolute joint locations (B, L, J, 3) for every input frame."""

    def __init__(self, filter_widths: Sequence[int] = (3, 3, 3, 3),
                 channels: int = 1024, p_dropout: float = 0.25,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.filter_widths = tuple(filter_widths)
        self.channels, self.p_dropout = channels, p_dropout
        in_features = len(self.input_nodes) * 2
        self.expand_conv = TemporalConv(in_features, channels,
                                        self.filter_widths[0],
                                        generator=generator)
        self.BatchNorm_0 = BatchNorm(channels, BN_MOMENTUM)
        dilation = self.filter_widths[0]
        for i, width in enumerate(self.filter_widths[1:]):
            self.add_module(f"layer{i}_conv1", TemporalConv(
                channels, channels, width, dilation, generator))
            self.add_module(f"BatchNorm_{2 * i + 1}",
                            BatchNorm(channels, BN_MOMENTUM))
            self.add_module(f"layer{i}_conv2", TemporalConv(
                channels, channels, 1, generator=generator))
            self.add_module(f"BatchNorm_{2 * i + 2}",
                            BatchNorm(channels, BN_MOMENTUM))
            dilation *= width
        self.shrink = nn.Linear(channels, len(self.output_nodes) * 3)
        torch_dense_init_(self.shrink, generator)

    @property
    def receptive_field(self) -> int:
        return math.prod(self.filter_widths)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L = x.shape[:2]
        pad = self.receptive_field // 2
        frames = torch.arange(-pad, L + pad, device=x.device).clamp(0, L - 1)
        h = x[..., :2].reshape(B, L, -1)[:, frames]    # edge padding

        def bn_relu_drop(v, k):
            v = getattr(self, f"BatchNorm_{k}")(v, training)
            return dropout(F.relu(v), self.p_dropout, training, generator)

        h = bn_relu_drop(self.expand_conv(h), 0)
        dilation = self.filter_widths[0]
        for i, width in enumerate(self.filter_widths[1:]):
            # the residual is the un-convolved frames the conv output
            # aligns with (the public model's ``shift`` slicing)
            crop = dilation * (width - 1) // 2
            res = h[:, crop:h.shape[1] - crop]
            y = bn_relu_drop(getattr(self, f"layer{i}_conv1")(h), 2 * i + 1)
            y = bn_relu_drop(getattr(self, f"layer{i}_conv2")(y), 2 * i + 2)
            h = res + y
            dilation *= width
        return self.shrink(h).reshape(B, L, len(self.output_nodes), 3)
