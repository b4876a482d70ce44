"""SimpleTransformer: a post-norm transformer encoder over frames with
d_model = J * 2 (reference ``modules/movements/transformers.py``; the JAX
package's ``models/movements/transformers.py``, torch
``nn.TransformerEncoderLayer``'s defaults: 4 heads, feed-forward 2048,
ReLU, LayerNorm eps 1e-5, dropout 0.1).

The attention is flax's ``MultiHeadDotProductAttention``: the query scaled
by head_dim^-1/2, dropout on the attention weights with one (L, L) mask for
every clip and head (flax's ``broadcast_dropout``). Written in plain tensor
ops so that every dropout mask comes from the generator the flow passes
(``nn.TransformerEncoderLayer`` draws from the global RNG). Layers keep the
flax names (``_EncoderLayer_i``, ``MultiHeadDotProductAttention_0.query``,
``LayerNorm_0``, ``Dense_0``, ...), flax's inits (lecun normal, zero
biases).
"""
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ...flows.output_types import MovementsModelOutputType
from .common import FixedOutputModel, dropout, flax_dense

LN_EPS = 1e-5


class _Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention): ``query``,
    ``key``, ``value`` (D -> heads * head_dim) and ``out`` projections."""

    def __init__(self, dim: int, heads: int, rate: float,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.heads, self.rate = heads, rate
        for name in ("query", "key", "value", "out"):
            self.add_module(name, flax_dense(dim, dim, generator))

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L, D = x.shape
        q, k, v = (getattr(self, n)(x).view(B, L, self.heads, -1)
                   for n in ("query", "key", "value"))
        q = q / math.sqrt(q.shape[-1])
        weights = torch.einsum("bqhd,bkhd->bhqk", q, k).softmax(-1)
        if training and self.rate > 0.0:
            keep = torch.rand((L, L), generator=generator,
                              device=x.device) >= self.rate
            weights = weights * keep / (1.0 - self.rate)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v)
                        .reshape(B, L, D))


class _EncoderLayer(nn.Module):
    """torch ``TransformerEncoderLayer`` (post-norm, ReLU) equivalent."""

    def __init__(self, dim: int, heads: int, dim_feedforward: int = 2048,
                 rate: float = 0.1,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.rate = rate
        self.MultiHeadDotProductAttention_0 = _Attention(dim, heads, rate,
                                                         generator)
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.Dense_0 = flax_dense(dim, dim_feedforward, generator)
        self.Dense_1 = flax_dense(dim_feedforward, dim, generator)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        def drop(v):
            return dropout(v, self.rate, training, generator)
        attn = self.MultiHeadDotProductAttention_0(x, training, generator)
        x = self.LayerNorm_0(x + drop(attn))
        ff = self.Dense_1(drop(F.relu(self.Dense_0(x))))
        return self.LayerNorm_1(x + drop(ff))


class SimpleTransformer(FixedOutputModel):
    """2D poses in, 2D poses out: ``num_layers`` encoder layers over each
    clip's frames."""
    OUTPUT_TYPE = MovementsModelOutputType.pose_2d

    def __init__(self, n_heads: int = 4, num_layers: int = 6,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        d_model = len(self.input_nodes) * self.output_features
        if d_model % n_heads != 0:
            raise ValueError(
                f"d_model ({d_model}) must be divisible by n_heads")
        self.n_heads, self.num_layers = n_heads, num_layers
        for i in range(num_layers):
            self.add_module(f"_EncoderLayer_{i}", _EncoderLayer(
                d_model, n_heads, generator=generator))

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L, J = x.shape[:3]
        h = x[..., :self.output_features].reshape(B, L, -1)
        for i in range(self.num_layers):
            h = getattr(self, f"_EncoderLayer_{i}")(h, training, generator)
        return h.reshape(B, L, J, self.output_features)
