"""LSTM / GRU classifiers: [Dense embedding] + recurrent stack + Dense,
logits of the last frame (reference ``modules/classification/lstm.py:9-95``,
``gru.py``). The recurrent layers carry the flax cells' names
(``OptimizedLSTMCell_i``, ``GRUCell_i``), the Dense layers ``Dense_i``."""
from typing import Optional

import torch
from torch import nn

from ..movements.common import lecun_normal_
from ..rnn import HoistedGRU, HoistedLSTM
from .common import ClassificationModel, dropout


class _RecurrentClassifier(ClassificationModel):
    _layer_cls = None
    _cell_name = None

    def __init__(self, hidden_size: int = 64, num_layers: int = 2,
                 embeddings_size: int = 0, p_dropout: float = 0.25,
                 rnn_kernel: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        """``embeddings_size`` 0 means no embedding layer; ``rnn_kernel``
        ("auto" | "plain" | "fused") goes to the recurrent layers (see
        ``models/rnn.py``; GRU layers have no fused kernel)."""
        super().__init__(**kwargs)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.embeddings_size = embeddings_size
        self.p_dropout = p_dropout
        self.rnn_kernel = rnn_kernel
        width = len(self.input_nodes) * self.data_features
        denses = []
        if embeddings_size:
            denses.append(nn.Linear(width, embeddings_size))
            width = embeddings_size
        for i in range(num_layers):
            self.add_module(f"{self._cell_name}_{i}", self._layer_cls(
                width, hidden_size, kernel=rnn_kernel, generator=generator))
            width = hidden_size
        denses.append(nn.Linear(hidden_size, self.num_classes))
        for i, dense in enumerate(denses):
            lecun_normal_(dense.weight, generator)
            nn.init.zeros_(dense.bias)
            self.add_module(f"Dense_{i}", dense)
        self._num_denses = len(denses)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L = x.shape[:2]
        h = x.reshape(B, L, -1)
        if self.embeddings_size:
            h = self.Dense_0(h)
        h = dropout(h, self.p_dropout, training, generator)
        for i in range(self.num_layers):
            _, h = getattr(self, f"{self._cell_name}_{i}")(h)
        return getattr(self, f"Dense_{self._num_denses - 1}")(h[:, -1])


class LSTM(_RecurrentClassifier):
    _layer_cls = HoistedLSTM
    _cell_name = "OptimizedLSTMCell"


class GRU(_RecurrentClassifier):
    _layer_cls = HoistedGRU
    _cell_name = "GRUCell"
