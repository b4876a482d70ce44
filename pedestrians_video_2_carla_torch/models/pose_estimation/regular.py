"""Frame regressors on a pooled ResNet-50: P0 (cascaded atrous modules) and
AvPedestrianPoseTransformer (a transformer encoder over the frames); the
JAX package's ``models/pose_estimation/regular.py``. The frame axis folds
into the batch for the backbone."""
from typing import Optional, Sequence

import torch
from torch.nn import functional as F

from ..backbones.resnet import batch_norm, conv2d, resnet50
from ..movements.common import dropout, flax_dense
from ..movements.transformers import _EncoderLayer
from .linear import PoseEstimationModel


class _AtrousModule(torch.nn.Module):
    """A 1x1 conv (its dilation changes nothing on a 1x1 kernel) ->
    BatchNorm -> ReLU."""

    def __init__(self, in_features: int, features: int, dilation: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.Conv_0 = conv2d(in_features, features, 1, dilation=dilation,
                             generator=generator)
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x, training: bool = False):
        return F.relu(self.BatchNorm_0(self.Conv_0(x), training))


def _pooled_frames(backbone, x: torch.Tensor, training: bool):
    """(B, L, 3, H, W) -> the backbone's features averaged over each
    frame, (B, L, C)."""
    B, L = x.shape[:2]
    high, _ = backbone(x.reshape(B * L, *x.shape[2:]), training)
    return high.mean(dim=(2, 3)).reshape(B, L, -1)


class P0(PoseEstimationModel):
    """ResNet-50 (pooled) -> cascaded atrous modules -> Dense -> dropout
    0.5 -> ReLU -> (J, 2)."""
    P_DROPOUT = 0.5

    def __init__(self, dilations: Sequence[int] = (24, 18, 12, 6),
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.ResNet_0 = resnet50(generator=generator)
        self.dilations = tuple(dilations)
        in_features = self.ResNet_0.out_features
        for i, d in enumerate(self.dilations):
            self.add_module(f"_AtrousModule_{i}", _AtrousModule(
                in_features, 256, d, generator))
            in_features = 256
        self.linear_second = flax_dense(256, len(self.output_nodes) * 2,
                                        generator)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L = x.shape[:2]
        h = _pooled_frames(self.ResNet_0, x, training)
        h = h.reshape(B * L, -1, 1, 1)
        for i in range(len(self.dilations)):
            h = getattr(self, f"_AtrousModule_{i}")(h, training)
        h = self.linear_second(h.reshape(B, L, -1))
        h = F.relu(dropout(h, self.P_DROPOUT, training, generator))
        return h.reshape(B, L, len(self.output_nodes), 2)


class AvPedestrianPoseTransformer(PoseEstimationModel):
    """ResNet-50 (pooled) -> two Dense layers -> ``num_layers`` transformer
    encoder layers over the frames (d_model = 2 J, ``n_heads`` heads) ->
    Dense -> (J, 2); dropout 0.5 between them."""
    P_DROPOUT = 0.5

    def __init__(self, num_layers: int = 6, n_heads: int = 4,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        d_model = len(self.output_nodes) * 2
        self.num_layers, self.n_heads = num_layers, n_heads
        self.ResNet_0 = resnet50(generator=generator)
        self.linear_first = flax_dense(self.ResNet_0.out_features, 256,
                                       generator)
        self.linear_second = flax_dense(256, d_model, generator)
        for i in range(num_layers):
            self.add_module(f"_EncoderLayer_{i}", _EncoderLayer(
                d_model, n_heads, generator=generator))
        self.linear_after_transformer = flax_dense(d_model, d_model,
                                                   generator)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L = x.shape[:2]

        def drop(v):
            return dropout(v, self.P_DROPOUT, training, generator)
        h = _pooled_frames(self.ResNet_0, x, training)
        h = F.relu(drop(self.linear_first(h)))
        h = F.relu(drop(self.linear_second(h)))
        for i in range(self.num_layers):
            h = getattr(self, f"_EncoderLayer_{i}")(h, training, generator)
        h = self.linear_after_transformer(F.relu(drop(h)))
        return h.reshape(B, L, len(self.output_nodes), 2)
