"""Spatial-GNN 2D-pose autoencoders over the skeleton graph, per frame
(reference ``modules/movements/spatial_gnn.py``; the JAX package's
``models/movements/spatial_gnn.py``), in the dense-adjacency form:

* ``SpatialGnn``: three PointTransformerConv-style attention convolutions
  (scores -||q - k||^2 / sqrt(features) over each joint's neighbours and
  itself, the unnormalised adjacency with self loops), then a 2-wide head;
* ``GNNLinearAutoencoder``: a two-layer GCN encoder (the normalised
  adjacency) and a linear decoder over each frame's joints;
* ``VariationalGcn``: the same with a (mu, logvar) encoder; training
  samples z = mu + exp(logvar / 2) eps with eps from the flow's generator
  (not the JAX PRNG's draws, ``ROADMAP.md`` F3), evaluation takes z = mu.

Layers keep the flax names and flax's Dense init (lecun normal, zero
biases). The adjacency is a non-persistent buffer.
"""
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ...flows.output_types import MovementsModelOutputType
from .common import FixedOutputModel, flax_dense


class _GraphAutoencoder(FixedOutputModel):
    """2D poses in and out over the input skeleton's adjacency
    (``normalized`` and with self loops, as ``get_adjacency_matrix``
    gives it)."""
    OUTPUT_TYPE = MovementsModelOutputType.pose_2d
    NORMALIZED = True

    def __init__(self, hidden_size: int = 16, **kwargs) -> None:
        super().__init__(**kwargs)
        self.hidden_size = hidden_size
        self.register_buffer("adjacency", torch.from_numpy(
            self.input_nodes.get_adjacency_matrix(
                normalized=self.NORMALIZED, self_loops=True)),
            persistent=False)

    def gcn(self, v: torch.Tensor, dense: nn.Linear) -> torch.Tensor:
        return dense(torch.einsum("ij,...jc->...ic", self.adjacency.to(v.dtype), v))


class SpatialGnn(_GraphAutoencoder):
    NORMALIZED = False

    def __init__(self, hidden_size: int = 32,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(hidden_size=hidden_size, **kwargs)
        widths = {"enc1": hidden_size, "enc2": hidden_size // 2,
                  "dec1": hidden_size}
        fan_in = 2
        for name, width in widths.items():
            for part in ("q", "k", "v"):
                self.add_module(f"{name}_{part}",
                                flax_dense(fan_in, width, generator))
            fan_in = width
        self.out = flax_dense(hidden_size, 2, generator)

    def attention_conv(self, v: torch.Tensor, name: str) -> torch.Tensor:
        q, k, val = (getattr(self, f"{name}_{p}")(v) for p in "qkv")
        scores = -((q[..., :, None, :] - k[..., None, :, :]) ** 2).sum(-1) \
            / math.sqrt(q.shape[-1])
        scores = torch.where(self.adjacency > 0, scores,
                             torch.full_like(scores, -1e9))
        return torch.einsum("...ij,...jc->...ic", scores.softmax(-1), val)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False):
        h = x[..., :2]
        for name in ("enc1", "enc2", "dec1"):
            h = F.relu(self.attention_conv(h, name))
        return self.out(h)


class GNNLinearAutoencoder(_GraphAutoencoder):
    def __init__(self, hidden_size: int = 16,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(hidden_size=hidden_size, **kwargs)
        J = len(self.input_nodes)
        self.Dense_0 = flax_dense(2, hidden_size, generator)
        self.Dense_1 = flax_dense(hidden_size, hidden_size // 2, generator)
        self.Dense_2 = flax_dense(J * (hidden_size // 2), J * 2, generator)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False):
        B, L, J = x.shape[:3]
        z = self.gcn(F.relu(self.gcn(x[..., :2], self.Dense_0)), self.Dense_1)
        return self.Dense_2(z.reshape(B, L, -1)).reshape(B, L, J, 2)


class VariationalGcn(_GraphAutoencoder):
    def __init__(self, hidden_size: int = 16,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(hidden_size=hidden_size, **kwargs)
        J = len(self.input_nodes)
        self.Dense_0 = flax_dense(2, hidden_size, generator)
        self.Dense_1 = flax_dense(hidden_size, hidden_size // 2, generator)
        self.Dense_2 = flax_dense(hidden_size, hidden_size // 2, generator)
        self.Dense_3 = flax_dense(J * (hidden_size // 2), J * 2, generator)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L, J = x.shape[:3]
        h = F.relu(self.gcn(x[..., :2], self.Dense_0))
        mu = self.gcn(h, self.Dense_1)
        if training:
            if generator is None:
                raise ValueError("VariationalGcn in training needs a "
                                 "generator")
            logvar = self.gcn(h, self.Dense_2)
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
            z = mu + torch.exp(0.5 * logvar) * eps
        else:
            z = mu
        return self.Dense_3(z.reshape(B, L, -1)).reshape(B, L, J, 2)
