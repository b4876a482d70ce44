"""Linear + LSTM + Linear movements model (reference
``modules/movements/lstm.py:6-81``; default 2 layers, hidden 64). Its
layers start from zeros, so ``rnn_kernel="fused"`` runs them through the
dense LSTM kernels on the card (``models/rnn.py``)."""
from typing import Optional

import torch
from torch import nn

from ..rnn import HoistedLSTM
from .common import MovementsModel, lecun_normal_


class LSTM(MovementsModel):
    """``embeddings_size`` 0 means no embedding layer. Names as the flax
    tree: ``Dense_0`` (the embedding, if any), ``OptimizedLSTMCell_{i}``,
    then the output ``Dense_{0 or 1}``; flax's inits."""

    def __init__(self, hidden_size: int = 64, num_layers: int = 2,
                 embeddings_size: int = 0, rnn_kernel: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.embeddings_size = embeddings_size
        self.rnn_kernel = rnn_kernel
        width = len(self.input_nodes) * self.input_features
        denses = []
        if embeddings_size:
            denses.append(nn.Linear(width, embeddings_size))
            width = embeddings_size
        for i in range(num_layers):
            self.add_module(f"OptimizedLSTMCell_{i}", HoistedLSTM(
                width, hidden_size, kernel=rnn_kernel, generator=generator))
            width = hidden_size
        denses.append(nn.Linear(hidden_size, len(self.output_nodes)
                                * self.output_features))
        for i, dense in enumerate(denses):
            lecun_normal_(dense.weight, generator)
            nn.init.zeros_(dense.bias)
            self.add_module(f"Dense_{i}", dense)
        self._num_denses = len(denses)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False):
        B, L = x.shape[:2]
        h = x.reshape(B, L, -1)
        if self.embeddings_size:
            h = self.Dense_0(h)
        for i in range(self.num_layers):
            _, h = getattr(self, f"OptimizedLSTMCell_{i}")(h)
        out = getattr(self, f"Dense_{self._num_denses - 1}")(h)
        return self.format_output(out.reshape(
            B, L, len(self.output_nodes), self.output_features))
