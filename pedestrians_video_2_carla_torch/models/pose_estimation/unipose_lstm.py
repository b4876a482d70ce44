"""UniPoseLSTM (UniPose with a convolutional LSTM over the frames): clips of
frames -> per-joint heatmaps (the JAX package's
``models/pose_estimation/unipose_lstm.py``).

A ResNet backbone at output stride 8 or 16 takes each frame with a
constant centre Gaussian as its 4th channel; WASP (waterfall atrous
spatial pooling) and a decoder that fuses the backbone's low-level
features give 1/4-scale maps, resized to 1/``stride``; a ConvLSTM runs
over the frames and a 1x1 head gives J + 1 maps (the last the background).

The resizes are ``jax.image.resize``'s bilinear: antialiased where they
shrink (``F.interpolate(antialias=True)``), plain bilinear where they grow.
The ConvLSTM's input half, ``conv(concat(x, h)) = conv_x(x) + conv_h(h)``,
runs once over every frame of the clip (the kernel's input-channel slice
of x); the loop over the frames convolves h alone, from zeros. Modules
keep the flax names (``ResNet_0``, ``WASP_0``, ``Decoder_0``,
``conv_lstm.Conv_0``, ``head``).
"""
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ...flows.output_types import PoseEstimationModelOutputType
from ...ops.heatmaps import gaussian_heatmaps
from ..backbones.resnet import batch_norm, conv2d, resnet50, resnet101
from .linear import PoseEstimationModel

BACKBONES = {"resnet50": resnet50, "resnet101": resnet101}


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of an NCHW map to ``size``
    (H, W): its triangle kernel widens with the scale where the map
    shrinks, which is PyTorch's antialiased bilinear."""
    shrinks = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=shrinks)


class _AtrousBranch(nn.Module):
    def __init__(self, in_features: int, features: int, dilation: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.Conv_0 = conv2d(in_features, features, 3, padding=dilation,
                             dilation=dilation, generator=generator)
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x, training: bool = False):
        return F.relu(self.BatchNorm_0(self.Conv_0(x), training))


class WASP(nn.Module):
    """Cascaded atrous branches, each also projected by a 1x1 conv, and a
    global-pooling branch, concatenated and fused by a 1x1 conv."""

    def __init__(self, in_features: int, features: int = 256,
                 dilations: Sequence[int] = (6, 12, 18, 24),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dilations = tuple(dilations)
        n = len(self.dilations)
        width = in_features
        for i, d in enumerate(self.dilations):
            self.add_module(f"_AtrousBranch_{i}", _AtrousBranch(
                width, features, d, generator))
            self.add_module(f"Conv_{i}", conv2d(features, features, 1,
                                                bias=True,
                                                generator=generator))
            width = features
        self.add_module(f"Conv_{n}", conv2d(in_features, features, 1,
                                            bias=True, generator=generator))
        self.add_module(f"Conv_{n + 1}", conv2d(features * (n + 1), features,
                                                1, generator=generator))
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x, training: bool = False):
        n = len(self.dilations)
        outs, h = [], x
        for i in range(n):
            h = getattr(self, f"_AtrousBranch_{i}")(h, training)
            outs.append(getattr(self, f"Conv_{i}")(h))
        gp = F.relu(getattr(self, f"Conv_{n}")(
            x.mean(dim=(2, 3), keepdim=True)))
        outs.append(gp.expand(-1, -1, *outs[0].shape[2:]))
        y = getattr(self, f"Conv_{n + 1}")(torch.cat(outs, dim=1))
        return F.relu(self.BatchNorm_0(y, training))


class Decoder(nn.Module):
    """WASP's features, upsampled to the low-level features' scale and
    fused with them -> ``num_classes`` maps."""

    def __init__(self, in_features: int, low_features: int,
                 num_classes: int, features: int = 256,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.Conv_0 = conv2d(low_features, 48, 1, generator=generator)
        self.BatchNorm_0 = batch_norm(48)
        self.Conv_1 = conv2d(in_features + 48, features, 3, padding=1,
                             generator=generator)
        self.BatchNorm_1 = batch_norm(features)
        self.Conv_2 = conv2d(features, features, 3, padding=1,
                             generator=generator)
        self.BatchNorm_2 = batch_norm(features)
        self.Conv_3 = conv2d(features, num_classes, 1, bias=True,
                             generator=generator)

    def forward(self, x, low_level, training: bool = False):
        low = F.relu(self.BatchNorm_0(self.Conv_0(low_level), training))
        y = torch.cat([resize_bilinear(x, low.shape[-2:]), low], dim=1)
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), training))
        y = F.relu(self.BatchNorm_2(self.Conv_2(y), training))
        return self.Conv_3(y)


class ConvLSTM(nn.Module):
    """The JAX ``_ConvLSTMStep`` scanned over the frames: ``Conv_0`` is
    the 3x3 gate conv over concat(x_t, h) (gates i, f, g, o)."""

    def __init__(self, features: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.features = features
        self.Conv_0 = conv2d(2 * features, 4 * features, 3, padding=1,
                             bias=True, generator=generator)

    def forward(self, maps: torch.Tensor) -> torch.Tensor:
        """(B, L, F, h, w) -> the hidden state of every frame, same
        shape."""
        B, L, C, hh, ww = maps.shape
        weight, bias = self.Conv_0.weight, self.Conv_0.bias
        w_x, w_h = weight[:, :C], weight[:, C:]
        gates_x = F.conv2d(maps.reshape(B * L, C, hh, ww), w_x, bias,
                           padding=1).reshape(B, L, 4 * C, hh, ww)
        h = c = maps.new_zeros((B, C, hh, ww))
        outs = []
        for t in range(L):
            gates = gates_x[:, t] + F.conv2d(h, w_h, padding=1)
            i, f, g, o = gates.chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


class UniPoseLSTM(PoseEstimationModel):
    needs_heatmaps = True

    def __init__(self, stride: int = 8, output_stride: int = 16,
                 backbone: str = "resnet101", sigma: float = 3.0,
                 lstm_features: int = 64,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        if backbone not in BACKBONES:
            raise ValueError(f"backbone {backbone!r}: one of "
                             f"{sorted(BACKBONES)}")
        self.stride, self.output_stride = stride, output_stride
        self.backbone, self.sigma = backbone, sigma
        self.lstm_features = lstm_features
        self.ResNet_0 = BACKBONES[backbone](output_stride=output_stride,
                                            in_channels=4,
                                            generator=generator)
        self.WASP_0 = WASP(self.ResNet_0.out_features, generator=generator)
        self.Decoder_0 = Decoder(256, 256, lstm_features,
                                 generator=generator)
        self.conv_lstm = ConvLSTM(lstm_features, generator)
        self.head = conv2d(lstm_features, len(self.output_nodes) + 1, 1,
                           bias=True, generator=generator)

    @property
    def output_type(self) -> PoseEstimationModelOutputType:
        return PoseEstimationModelOutputType.heatmaps

    @classmethod
    def supported_output_types(cls):
        return [PoseEstimationModelOutputType.heatmaps]

    def centermap(self, H: int, W: int, device) -> torch.Tensor:
        """The constant Gaussian at the frame's centre, (H, W)."""
        centre = torch.tensor([[W / 2.0, H / 2.0]], device=device)
        return gaussian_heatmaps(centre, (W, H), self.sigma,
                                 add_background=False)[0]

    def forward(self, x: torch.Tensor, targets=None, training: bool = False):
        """(B, L, 3, H, W) frames -> (B, L, J + 1, H / stride, W / stride)
        heatmaps, the background last."""
        B, L, C, H, W = x.shape
        frames = x.reshape(B * L, C, H, W)
        centre = self.centermap(H, W, x.device).to(x.dtype)
        frames = torch.cat([frames, centre.expand(B * L, 1, H, W)], dim=1)
        high, low = self.ResNet_0(frames, training)
        y = self.WASP_0(high, training)
        maps = self.Decoder_0(y, low, training)
        hh, ww = H // self.stride, W // self.stride
        maps = resize_bilinear(maps, (hh, ww))
        smoothed = self.conv_lstm(maps.reshape(B, L, -1, hh, ww))
        heatmaps = self.head(smoothed.reshape(B * L, -1, hh, ww))
        return heatmaps.reshape(B, L, -1, hh, ww)
