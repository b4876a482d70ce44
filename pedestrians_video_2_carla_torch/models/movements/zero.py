"""Identity / debug movements model (reference
``modules/movements/zero.py``)."""
from typing import Optional

import torch
from torch import nn

from ...flows.output_types import MovementsModelOutputType
from .common import MovementsModel


class ZeroMovements(MovementsModel):
    """Identity pose changes, or the 2D input passed through: the flow's
    plumbing end to end. One zero parameter, ``dummy``, gives the optimizer
    something to hold."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        if self.movements_output_type not in self.supported_output_types():
            raise ValueError(f"Unsupported movements output type: "
                             f"{self.movements_output_type}")
        self.dummy = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, targets=None, training: bool = False):
        if self.movements_output_type == \
                MovementsModelOutputType.pose_changes:
            B, L = x.shape[:2]
            return torch.eye(3, dtype=x.dtype, device=x.device).expand(
                B, L, len(self.output_nodes), 3, 3)
        return x[..., :2]

    @staticmethod
    def supported_output_types():
        return [MovementsModelOutputType.pose_changes,
                MovementsModelOutputType.pose_2d]
