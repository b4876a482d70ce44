"""Single-linear debug model (reference ``modules/movements/linear.py``)."""
from typing import Optional

import torch
from torch import nn

from .common import MovementsModel, lecun_normal_


class Linear(MovementsModel):
    """One dense layer (``Dense_0``, flax's init) over each frame's
    flattened joints."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        width = len(self.input_nodes) * self.input_features
        self.Dense_0 = nn.Linear(width, len(self.output_nodes)
                                 * self.output_features)
        lecun_normal_(self.Dense_0.weight, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False):
        B, L = x.shape[:2]
        out = self.Dense_0(x.reshape(B, L, -1))
        return self.format_output(out.reshape(
            B, L, len(self.output_nodes), self.output_features))
