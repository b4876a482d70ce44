"""Hoisted recurrent layers: a full-sequence LSTM / GRU with the input-side
gate projections lifted out of the loop over frames into one product over
the whole clip; only the (B, H) x (H, G H) hidden product and the gating
stay in the recurrence.

Math and parameter names are those of the flax cells the JAX package
mirrors (``OptimizedLSTMCell``: ``i{i,f,g,o}`` weight only, ``h{i,f,g,o}``
weight and bias, gate order i, f, g, o; ``GRUCell``: ``i{r,z,n}`` weight and
bias, ``h{r,z}`` weight only, ``hn`` weight and bias, candidate
``tanh(x Wn + r (h Whn + bn))``), as nn.Linear sub-modules, so a flax tree
loads through ``models/jax_import.py``.

``HoistedLSTM(kernel="fused")`` runs the recurrence through
``ops/fused_graph_gru.py::graph_lstm_scan`` with no graph matrices and one
"joint" (a plain dense LSTM over the batch rows): the dense LSTM kernels on
the card (``csrc/fused_dense_lstm.cu``, up to H = 64, which read the stacked
hidden weight's transpose in place; wider layers take the graph-form
kernels, which copy it once), in float32 or bf16, their plain version on
the CPU. The hidden biases ride in the hoisted input product, taken
frame-major, so the scan's input is that product's output, uncopied.
``"auto"`` keeps the loop in PyTorch
ops, as the JAX package's ``auto`` keeps its scan; an explicit
``initial_carry`` always takes the loop.

``init="torch"`` draws every kernel and bias from ``nn.LSTM``'s
U(+-1/sqrt(H)) (the JAX package's ``torch_hoisted_lstm`` /
``torch_lstm_cell``, which the Seq2Seq family uses) in place of flax's
families. :class:`LSTMCell` is one step of the same layer, for the
Seq2Seq decoder.
"""
import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.fused_graph_gru import graph_lstm_scan
from .movements.common import _uniform_, lecun_normal_, orthogonal_

RNN_KERNELS = ("auto", "plain", "fused")
RNN_INITS = ("flax", "torch")


def _check_kernel(kernel: str) -> None:
    if kernel in ("xla", "pallas"):
        raise ValueError(
            f"kernel {kernel!r} is the JAX package's name; the port's are "
            "'plain' (xla) and 'fused' (pallas)")
    if kernel not in RNN_KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {RNN_KERNELS}")


class _Hoisted(nn.Module):
    """Input denses ``i<gate>`` and hidden denses ``h<gate>`` of one
    recurrent layer."""
    GATES = ""
    INPUT_BIAS = False
    HIDDEN_BIAS = ""     # the gates whose hidden dense has a bias

    def __init__(self, in_features: int, features: int, reverse: bool = False,
                 kernel: str = "auto", init: str = "flax",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        _check_kernel(kernel)
        if init not in RNN_INITS:
            raise ValueError(f"unknown init {init!r}; one of {RNN_INITS}")
        self.init = init
        self.features = features
        self.reverse = reverse
        self.kernel = kernel
        for gate in self.GATES:
            self.add_module(f"i{gate}", nn.Linear(in_features, features,
                                                  bias=self.INPUT_BIAS))
            self.add_module(f"h{gate}", nn.Linear(
                features, features, bias=gate in self.HIDDEN_BIAS))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's families (input kernels lecun-normal, recurrent kernels
        orthogonal, biases zero), or with ``init="torch"`` every kernel and
        bias U(+-1/sqrt(H))."""
        if self.init == "torch":
            for p in self.parameters():
                _uniform_(p, 1.0 / math.sqrt(self.features), generator)
            return
        for gate in self.GATES:
            lecun_normal_(getattr(self, f"i{gate}").weight, generator)
            orthogonal_(getattr(self, f"h{gate}").weight, generator)
            for dense in (getattr(self, f"i{gate}"),
                          getattr(self, f"h{gate}")):
                if dense.bias is not None:
                    nn.init.zeros_(dense.bias)

    def _stacked(self, side: str) -> torch.Tensor:
        """(G H, in): the gates' nn.Linear weights, gate-major."""
        return torch.cat([getattr(self, f"{side}{g}").weight
                          for g in self.GATES], dim=0)

    def _frames(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        """The hoisted input projection, frame-major and in processing
        order: (B, L, E) -> (L, B, G H), contiguous. The product runs on the
        frame-major (and, with ``reverse``, flipped) input, the narrow side,
        so that its output needs no copy."""
        xt = x.transpose(0, 1)
        return F.linear(xt.flip(0) if self.reverse else xt,
                        self._stacked("i"), bias)


class HoistedLSTM(_Hoisted):
    """One LSTM layer over a whole (B, L, E) sequence. Returns ``(carry,
    outputs)`` with the carry as ``(c, h)`` and outputs (B, L, H); with
    ``reverse`` the sequence is processed back to front and the outputs
    stay in processing order."""
    GATES = "ifgo"
    HIDDEN_BIAS = "ifgo"

    def forward(self, x: torch.Tensor,
                initial_carry: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None):
        B, L, _ = x.shape
        H = self.features
        # the hidden biases folded into the input product's
        b_h = torch.cat([getattr(self, f"h{g}").bias for g in self.GATES])
        gx = self._frames(x, b_h)                             # (L, B, 4H)
        w_h = self._stacked("h")                              # (4H, H)
        if self.kernel == "fused" and initial_carry is None:
            cheb = x.new_zeros((0, 1, 1))
            ys, cs = graph_lstm_scan(gx.unsqueeze(2), cheb, w_h.t(),
                                     with_c=True)
            return (cs[-1, :, 0], ys[-1, :, 0]), ys[:, :, 0].transpose(0, 1)
        if initial_carry is None:
            c = h = x.new_zeros((B, H))
        else:
            c, h = initial_carry
        hs = []
        for t in range(L):
            gi, gf, gg, go = (F.linear(h, w_h) + gx[t]).split(H, dim=-1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            hs.append(h)
        return (c, h), torch.stack(hs, dim=1)


class LSTMCell(_Hoisted):
    """One LSTM step with flax ``OptimizedLSTMCell``'s parameters and gate
    order (``i{i,f,g,o}`` weight only, ``h{i,f,g,o}`` weight and bias):
    ``(c, h), x -> (c', h'), h'``."""
    GATES = "ifgo"
    HIDDEN_BIAS = "ifgo"

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor):
        c, h = carry
        H = self.features
        b_h = torch.cat([getattr(self, f"h{g}").bias for g in self.GATES])
        y = F.linear(h, self._stacked("h"), b_h) \
            + F.linear(x, self._stacked("i"))
        gi, gf, gg, go = y.split(H, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        return (c, h), h


class HoistedGRU(_Hoisted):
    """One GRU layer over a whole (B, L, E) sequence: ``(carry h,
    outputs (B, L, H))``. ``kernel`` is kept for symmetry with
    :class:`HoistedLSTM`: the candidate gate's ``r (h W + b)`` form has no
    fused kernel, so every value runs the loop."""
    GATES = "rzn"
    INPUT_BIAS = True
    HIDDEN_BIAS = "n"

    def forward(self, x: torch.Tensor,
                initial_carry: Optional[torch.Tensor] = None):
        B, L, _ = x.shape
        H = self.features
        b_i = torch.cat([getattr(self, f"i{g}").bias for g in self.GATES])
        gx = self._frames(x, b_i)                             # (L, B, 3H)
        w_h = self._stacked("h")                              # (3H, H)
        b_n = self.hn.bias
        h = x.new_zeros((B, H)) if initial_carry is None else initial_carry
        hs = []
        for t in range(L):
            xr, xz, xn = gx[t].split(H, dim=-1)
            hr, hz, hn = F.linear(h, w_h).split(H, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * (hn + b_n))
            h = (1.0 - z) * n + z * h
            hs.append(h)
        return h, torch.stack(hs, dim=1)
