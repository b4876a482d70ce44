"""ResNet-50/101 (NCHW, bottleneck blocks) with an optional output stride of
8 or 16 by dilation (DeepLab's rule, as UniPose's backbone uses), and the
renaming of a torchvision ``state_dict`` onto it (the JAX package's
``models/backbones/resnet.py``).

Modules keep the flax names (``conv1``, ``bn1``, ``layer{s}_{b}`` with
``conv1..3``, ``bn1..3``, ``downsample_conv``, ``downsample_bn``), so that
the flax weight bridge and a torchvision checkpoint both find them.
Convolutions are ``nn.Conv2d`` (cuDNN on the card): the JAX package runs
them outside any Pallas kernel. Inits are flax's: lecun-normal kernels,
BatchNorm scale 1 and bias 0, drawn from an explicit generator.
"""
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..movements.common import BatchNorm, trunc_normal_

#: the std of a unit normal truncated at +-2
_TRUNC_STD = .87962566103423978


def conv2d(in_features: int, features: int, kernel: int, stride: int = 1,
           padding: int = 0, dilation: int = 1, bias: bool = False,
           generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """An ``nn.Conv2d`` initialised as flax's ``nn.Conv``: a lecun-normal
    kernel (fan_in = in * kh * kw) from ``generator``, a zero bias.
    ``padding`` is symmetric, as flax's explicit padding and, for a 3x3
    kernel at stride 1, its ``"SAME"``."""
    layer = nn.utils.skip_init(nn.Conv2d, in_features, features, kernel,
                               stride=stride, padding=padding,
                               dilation=dilation, bias=bias)
    fan_in = in_features * kernel * kernel
    trunc_normal_(layer.weight, math.sqrt(1.0 / fan_in) / _TRUNC_STD,
                  generator)
    if bias:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


def batch_norm(features: int) -> BatchNorm:
    """flax's ``nn.BatchNorm`` on an NCHW map: over the channels."""
    return BatchNorm(features, axis=1)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dilation: int = 1,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        out = features * self.expansion
        self.conv1 = conv2d(in_features, features, 1, generator=generator)
        self.bn1 = batch_norm(features)
        self.conv2 = conv2d(features, features, 3, stride=strides,
                            padding=dilation, dilation=dilation,
                            generator=generator)
        self.bn2 = batch_norm(features)
        self.conv3 = conv2d(features, out, 1, generator=generator)
        self.bn3 = batch_norm(out)
        self.has_downsample = in_features != out or strides != 1
        if self.has_downsample:
            self.downsample_conv = conv2d(in_features, out, 1, stride=strides,
                                          generator=generator)
            self.downsample_bn = batch_norm(out)

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), training))
        y = F.relu(self.bn2(self.conv2(y), training))
        y = self.bn3(self.conv3(y), training)
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x), training)
        return F.relu(y + residual)


#: (strides, dilations) of the four stages at each output stride
OUTPUT_STRIDES = {None: ((1, 2, 2, 2), (1, 1, 1, 1)),
                  16: ((1, 2, 2, 1), (1, 1, 1, 2)),
                  8: ((1, 2, 1, 1), (1, 1, 2, 4))}


class ResNet(nn.Module):
    """(N, in_channels, H, W) -> (the high-level features, the low-level
    ones after the first stage), as DeepLab's backbones return them."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 output_stride: Optional[int] = None, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if output_stride not in OUTPUT_STRIDES:
            raise ValueError(f"output_stride {output_stride!r}: one of "
                             f"{list(OUTPUT_STRIDES)}")
        strides, dilations = OUTPUT_STRIDES[output_stride]
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = conv2d(in_channels, 64, 7, stride=2, padding=3,
                            generator=generator)
        self.bn1 = batch_norm(64)
        in_features = 64
        for stage, blocks in enumerate(self.stage_sizes):
            features = 64 * 2 ** stage
            for block in range(blocks):
                self.add_module(f"layer{stage + 1}_{block}", Bottleneck(
                    in_features, features,
                    strides=strides[stage] if block == 0 else 1,
                    dilation=dilations[stage], generator=generator))
                in_features = features * Bottleneck.expansion
        self.out_features = in_features

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x), training))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        low_level = None
        for stage, blocks in enumerate(self.stage_sizes):
            for block in range(blocks):
                y = getattr(self, f"layer{stage + 1}_{block}")(y, training)
            if stage == 0:
                low_level = y
        return y, low_level


RESNET50_STAGES = (3, 4, 6, 3)
RESNET101_STAGES = (3, 4, 23, 3)


def resnet50(**kwargs) -> ResNet:
    return ResNet(stage_sizes=RESNET50_STAGES, **kwargs)


def resnet101(**kwargs) -> ResNet:
    return ResNet(stage_sizes=RESNET101_STAGES, **kwargs)


def import_torchvision_resnet(state_dict: Dict[str, np.ndarray],
                              stage_sizes: Sequence[int] = RESNET50_STAGES
                              ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet ``state_dict`` (numpy or tensors) -> the port's
    ``ResNet`` state_dict: the layouts are the same, so only the names
    change (``layer1.0.conv1`` -> ``layer1_0.conv1``, ``downsample.0`` /
    ``.1`` -> ``downsample_conv`` / ``downsample_bn``); the blocks of
    ``stage_sizes`` are read, ``fc`` and ``num_batches_tracked`` are not.
    A missing key raises ``KeyError``."""
    out: Dict[str, torch.Tensor] = {}

    def take(src, dst):
        out[dst] = torch.as_tensor(np.array(state_dict[src], np.float32))

    def conv(src, dst):
        take(f"{src}.weight", f"{dst}.weight")

    def bn(src, dst):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            take(f"{src}.{leaf}", f"{dst}.{leaf}")

    conv("conv1", "conv1")
    bn("bn1", "bn1")
    for stage, blocks in enumerate(stage_sizes):
        for block in range(blocks):
            t, f = f"layer{stage + 1}.{block}", f"layer{stage + 1}_{block}"
            for i in (1, 2, 3):
                conv(f"{t}.conv{i}", f"{f}.conv{i}")
                bn(f"{t}.bn{i}", f"{f}.bn{i}")
            if f"{t}.downsample.0.weight" in state_dict:
                conv(f"{t}.downsample.0", f"{f}.downsample_conv")
                bn(f"{t}.downsample.1", f"{f}.downsample_bn")
    return out
