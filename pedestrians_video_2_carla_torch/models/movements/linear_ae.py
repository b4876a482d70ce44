"""Linear autoencoder (reference ``modules/movements/linear_ae/linear_ae.py``).
Only ``LinearAE`` is ported so far."""
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .common import MovementsModel, identity_head_init_, torch_dense_init_


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
