"""Dense-adjacency graph classifiers (reference
``modules/classification/gnn/``: torch_geometric_temporal GConvGRU / DCRNN /
TGCN / GConvLSTM recurrent graph layers, and the two GCN classifiers
``GCNBestPaper`` and ``GCNBestPaperTransformer``). Skeleton graphs are tiny
static 26-node graphs, so a Chebyshev or GCN convolution is a dense (J, J)
product batched over (batch, frame); the GCN classifiers have no scan and
run in plain PyTorch ops on every device.

The input-side graph convolutions of every gate do not depend on the carry,
so they run for the whole clip in one product; only the hidden-side
convolutions are part of the frame recurrence. ``graph_kernel`` picks how
that recurrence runs:
  * ``"plain"`` (the JAX package's ``xla``): a loop over frames of the cell
    in PyTorch ops, the hidden-side bias added inside the cell;
  * ``"fused"`` (its ``pallas``): the scan entries of
    ``ops/fused_graph_gru.py``, one per layer -- CUDA kernels, forward and
    backward, on the card, their plain versions on the CPU; both biases fold
    into the clip-level pre-activations, and the layers hand frame-major
    (L, B, J, H) tensors to each other with no relayout;
  * ``"auto"``: fused on the card when ``hidden_size >= 32`` and the scan
    kernels' launch plans (``graph_gru_plan``, ``graph_lstm_plan``,
    ``dense_lstm_plan``) take the layer's shape, forward and, when a
    gradient will be taken, backward; else plain. The choice is made from
    the plans before any launch; ``"fused"`` raises where they refuse. The
    plans and the kernels take float32 and bf16 alike (a flow's
    ``precision="bf16"``), as the JAX package's ``auto`` does.
Dropout sits outside the recurrence, so the fused route trains as well.

Parameters carry the flax model's names and (in, out) shapes
(``rnn1_z_wx0``, ``rnn1_z_wh0``, ``rnn1_z_bx``, ``rnn1_z_bh``, ...; the
Dense heads as ``Dense_i.weight`` / ``.bias`` in nn.Linear layout);
``models/jax_import.py::import_classification`` carries a flax tree over.
The recurrent classifiers read the mean-pooled node embeddings of the last
frame.
"""
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...flows.output_types import ClassificationModelOutputType
from ...ops.fused_graph_gru import (cheb_matrices, dense_lstm_plan,
                                    graph_gru_plan, graph_gru_scan,
                                    graph_lstm_plan, graph_lstm_scan)
from ..movements.common import lecun_normal_
from .common import ClassificationModel, dropout, lecun_normal_in_out_

GRAPH_KERNELS = ("auto", "plain", "fused")


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def normalized_adjacency(skeleton, self_loops: bool = True) -> np.ndarray:
    return skeleton.get_adjacency_matrix(normalized=True,
                                         self_loops=self_loops)


def laplacian_op(skeleton) -> np.ndarray:
    """Scaled Chebyshev operator ~L = L - I (lambda_max = 2) with
    L = I - D^-1/2 A D^-1/2, i.e. -D^-1/2 A D^-1/2."""
    return -skeleton.get_adjacency_matrix(normalized=True, self_loops=False)


def cheb_stack(op: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """[T_0(op) x, ..., T_{k-1}(op) x] concatenated on the feature axis, by
    the recurrence on x (x: (..., J, C)); op in x's dtype, as the JAX
    package casts it."""
    op = op.to(x.dtype)
    ts = [x]
    if k > 1:
        ts.append(torch.einsum("ij,...jc->...ic", op, x))
        for _ in range(k - 2):
            ts.append(2 * torch.einsum("ij,...jc->...ic", op, ts[-1])
                      - ts[-2])
    return ts[0] if k == 1 else torch.cat(ts, dim=-1)


class _GraphGatedRecurrent(ClassificationModel):
    """Shared machinery: two recurrent graph layers (gates defined by the
    subclass) + mean pool + Dense (reference ``gnn/rnn.py:8-70``)."""
    GATES: Tuple[str, ...] = ("z", "r", "h")
    LAYERS: Tuple[str, ...] = ("rnn1", "rnn2")

    def __init__(self, hidden_size: int = 128, p_dropout: float = 0.2,
                 k: int = 2, graph_kernel: str = "auto",
                 scan_unroll: int = 16,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        """``scan_unroll`` is the JAX package's unroll factor of its frame
        scans: the port's scans run one frame a step, in its kernels or in
        the plain loop, whatever it is."""
        super().__init__(**kwargs)
        if graph_kernel in ("xla", "pallas"):
            raise ValueError(
                f"graph_kernel {graph_kernel!r} is the JAX package's name; "
                "the port's are 'plain' (xla) and 'fused' (pallas)")
        if graph_kernel not in GRAPH_KERNELS:
            raise ValueError(f"unknown graph_kernel {graph_kernel!r}; one of "
                             f"{GRAPH_KERNELS}")
        self.hidden_size = hidden_size
        self.p_dropout = p_dropout
        self.k = k
        self.graph_kernel = graph_kernel
        self.scan_unroll = scan_unroll
        op = np.asarray(self._operator(), np.float32)
        self.register_buffer("op", torch.from_numpy(op), persistent=False)
        self.register_buffer("cheb", torch.from_numpy(cheb_matrices(op, k)),
                             persistent=False)
        # the forward keeps the first input_features channels of the data
        in_features = min(self.input_features, self.data_features)
        for layer in self.LAYERS:
            for gate in self.GATES:
                self._add_gate_params(layer, gate, in_features)
            in_features = hidden_size
        self._build_head()
        self.reset_parameters(generator)

    def _operator(self) -> np.ndarray:
        return laplacian_op(self.input_nodes)

    def _add_gate_params(self, layer: str, gate: str, in_features: int):
        H = self.hidden_size
        for i in range(self.k):
            self.register_parameter(f"{layer}_{gate}_wx{i}", nn.Parameter(
                torch.empty(in_features, H)))
            self.register_parameter(f"{layer}_{gate}_wh{i}", nn.Parameter(
                torch.empty(H, H)))
        for bias in ("bx", "bh"):
            self.register_parameter(f"{layer}_{gate}_{bias}", nn.Parameter(
                torch.zeros(H)))

    def _build_head(self) -> None:
        self.Dense_0 = nn.Linear(self.hidden_size, self.num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Seeded init in the flax model's families: gate and Dense kernels
        lecun-normal, biases zero."""
        for name, p in self.named_parameters():
            if p.ndim == 1:
                nn.init.zeros_(p)
            elif name.endswith(".weight"):
                lecun_normal_(p, generator)
            else:
                lecun_normal_in_out_(p, generator)

    # -- the layers' weights, assembled from the per-gate parameters --------
    def _gate(self, layer: str, gate: str, kind: str) -> List[torch.Tensor]:
        return [getattr(self, f"{layer}_{gate}_{kind}{i}")
                for i in range(self.k)]

    def _bias(self, layer: str, kind: str) -> torch.Tensor:
        return torch.cat([getattr(self, f"{layer}_{g}_{kind}")
                          for g in self.GATES])

    def _input_weight(self, layer: str) -> torch.Tensor:
        """(k C, G H): rows (n, feature), columns gate-major."""
        return torch.cat([torch.cat(self._gate(layer, g, "wx"), dim=0)
                          for g in self.GATES], dim=1)

    def _use_fused(self, x: torch.Tensor) -> bool:
        """The route of the recurrence on (B, L, J, C) ``x`` (see the module
        docstring); on the card it asks the launch plans, never a launch."""
        if self.graph_kernel == "plain":
            return False
        on_card = _on_card(x)
        if self.graph_kernel == "auto" and not (on_card and
                                                self.hidden_size >= 32):
            return False
        if not on_card:
            return True
        B, J = x.shape[0], x.shape[2]
        weight = self._gate(self.LAYERS[0], self.GATES[0], "wh")[0]
        keep = torch.is_grad_enabled() and (x.requires_grad
                                            or weight.requires_grad)
        if self._plans_take(B, J, keep, x.device):
            return True
        if self.graph_kernel == "fused":
            raise ValueError(
                f"graph_kernel='fused': the scan kernels take no "
                f"{'training ' if keep else ''}launch at hidden_size "
                f"{self.hidden_size}, k={self.k} for {B} clips of {J} "
                f"joints on this card (launch plan zero); use 'auto' or "
                f"'plain'")
        return False

    def _plans_take(self, B: int, J: int, keep: bool, device) -> bool:
        """Whether the scan kernels' launch plans take a layer of this
        shape: the forward's and, with ``keep``, the backward's."""
        raise NotImplementedError

    # -- plain route ----------------------------------------------------------
    def _hidden_weights(self, layer: str) -> Dict[str, Tuple[torch.Tensor,
                                                             torch.Tensor]]:
        """Per hidden group's leading gate: ((k H, len(group) H) weight,
        rows (n, unit); the group's hidden-side biases)."""
        raise NotImplementedError

    def _cell(self, hw, carry, xg_t):
        """One frame of the plain route: (carry', h')."""
        raise NotImplementedError

    def _init_carry(self, x: torch.Tensor):
        return x.new_zeros((x.shape[0], x.shape[2], self.hidden_size))

    def _layer_plain(self, layer: str, x: torch.Tensor) -> torch.Tensor:
        """(B, L, J, C) -> (B, L, J, H): clip-level input convs with the
        input-side bias, then the cell frame by frame."""
        x_all = cheb_stack(self.op, x, self.k) @ self._input_weight(layer) \
            + self._bias(layer, "bx")
        hw = self._hidden_weights(layer)
        carry = self._init_carry(x)
        ys = []
        for t in range(x.shape[1]):
            carry, h = self._cell(hw, carry, x_all[:, t])
            ys.append(h)
        return torch.stack(ys, dim=1)

    # -- fused route ----------------------------------------------------------
    def _scan(self, layer: str, xg: torch.Tensor) -> torch.Tensor:
        """The scan entry on (L, B, J, G H) pre-activations."""
        raise NotImplementedError

    def _layer_fused(self, layer: str, xs: torch.Tensor) -> torch.Tensor:
        """(L, B, J, C) -> (L, B, J, H): clip-level input convs with both
        biases folded in, then the scan entry."""
        xg = cheb_stack(self.op, xs, self.k) @ self._input_weight(layer) \
            + (self._bias(layer, "bx") + self._bias(layer, "bh"))
        return self._scan(layer, xg)

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x[..., :self.input_features]
        if self._use_fused(x):
            h = x.transpose(0, 1)                  # frame-major from here on
            for layer in self.LAYERS:
                h = F.relu(self._layer_fused(layer, h))
            last = h[-1]
        else:
            h = x
            for layer in self.LAYERS:
                h = F.relu(self._layer_plain(layer, h))
            last = h[:, -1]
        pooled = last.mean(dim=-2)        # pool the joints of the last frame
        pooled = dropout(pooled, self.p_dropout, training, generator)
        return self.Dense_0(pooled)


class _GraphGRUCell:
    """z and r both convolve h (one fused product); h~ convolves r h."""
    GATES = ("z", "r", "h")

    def _hidden_weights(self, layer):
        def stacked(gates):
            return (torch.cat([torch.cat(self._gate(layer, g, "wh"), dim=0)
                               for g in gates], dim=1),
                    torch.cat([getattr(self, f"{layer}_{g}_bh")
                               for g in gates]))
        return {"z": stacked(("z", "r")), "h": stacked(("h",))}

    def _cell(self, hw, h, xg_t):
        H = self.hidden_size
        zr = cheb_stack(self.op, h, self.k) @ hw["z"][0] + hw["z"][1]
        z = torch.sigmoid(xg_t[..., :H] + zr[..., :H])
        r = torch.sigmoid(xg_t[..., H:2 * H] + zr[..., H:])
        h_tilde = torch.tanh(
            xg_t[..., 2 * H:]
            + cheb_stack(self.op, r * h, self.k) @ hw["h"][0] + hw["h"][1])
        h_new = z * h + (1 - z) * h_tilde
        return h_new, h_new

    def _plans_take(self, B, J, keep, device):
        return all(graph_gru_plan(B, J, self.hidden_size, self.k, backward,
                                  device)[0] > 0
                   for backward in ((False, True) if keep else (False,)))

    def _scan(self, layer, xg):
        wz, wr = self._gate(layer, "z", "wh"), self._gate(layer, "r", "wh")
        wzr = torch.cat([torch.cat([wz[n], wr[n]], dim=1)
                         for n in range(self.k)], dim=1)    # (H, k 2H)
        wh = torch.cat(self._gate(layer, "h", "wh"), dim=1)  # (H, k H)
        return graph_gru_scan(xg, self.cheb.to(xg.dtype), wzr, wh)


class GConvGRU(_GraphGRUCell, _GraphGatedRecurrent):
    """Chebyshev graph-conv GRU (torch_geometric_temporal GConvGRU)."""


class DCRNN(_GraphGRUCell, _GraphGatedRecurrent):
    """Diffusion-convolution GRU; the diffusion operator is the normalized
    adjacency with self loops."""

    def _operator(self):
        return normalized_adjacency(self.input_nodes)


class TGCN(_GraphGRUCell, _GraphGatedRecurrent):
    """GCN + GRU: one-hop normalized-adjacency convolution in each gate."""

    def __init__(self, hidden_size: int = 128, p_dropout: float = 0.2,
                 k: int = 1, graph_kernel: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(hidden_size=hidden_size, p_dropout=p_dropout, k=k,
                         graph_kernel=graph_kernel, generator=generator,
                         **kwargs)

    def _operator(self):
        return normalized_adjacency(self.input_nodes)


class GConvLSTM(_GraphGatedRecurrent):
    """Chebyshev graph-conv LSTM (torch_geometric_temporal GConvLSTM): all
    four gates convolve h, so a frame is one fused product."""
    GATES = ("i", "f", "c", "o")

    def __init__(self, *args, scan_unroll: int = 1, **kwargs) -> None:
        super().__init__(*args, scan_unroll=scan_unroll, **kwargs)

    def _hidden_weights(self, layer):
        return {"i": (torch.cat([torch.cat(self._gate(layer, g, "wh"), dim=0)
                                 for g in self.GATES], dim=1),
                      self._bias(layer, "bh"))}

    def _init_carry(self, x):
        zeros = super()._init_carry(x)
        return zeros, zeros

    def _cell(self, hw, carry, xg_t):
        h, c = carry
        H = self.hidden_size
        acts = xg_t + cheb_stack(self.op, h, self.k) @ hw["i"][0] + hw["i"][1]
        i = torch.sigmoid(acts[..., :H])
        f = torch.sigmoid(acts[..., H:2 * H])
        g = torch.tanh(acts[..., 2 * H:3 * H])
        o = torch.sigmoid(acts[..., 3 * H:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        return (h_new, c_new), h_new

    def _plans_take(self, B, J, keep, device):
        H, k = self.hidden_size, self.k
        if k == 1:      # the route graph_lstm_scan takes: dense where it fits
            dense = dense_lstm_plan(B, J, H, k, device)
            if dense[0] > 0:
                return not keep or dense[3] > 0
        return all(graph_lstm_plan(B, J, H, k, backward, device)[0] > 0
                   for backward in ((False, True) if keep else (False,)))

    def _scan(self, layer, xg):
        per_gate = [self._gate(layer, g, "wh") for g in self.GATES]
        w = torch.cat([torch.cat([ws[n] for ws in per_gate], dim=1)
                       for n in range(self.k)], dim=1)   # (H, k 4H)
        return graph_lstm_scan(xg, self.cheb.to(xg.dtype), w)


class SpatialTemporalGNN(_GraphGRUCell, _GraphGatedRecurrent):
    """GConvGRU(K=3) over (x, y, confidence) node features + a per-frame
    MLP (reference ``gnn/spatial_temporal_gnn.py:10-114``; its second
    GConvGRU is defined but never applied, so a single recurrent layer is
    the faithful behaviour). Logits are read from the last frame. With
    ``graph_kernel="auto"`` its H = 3 keeps the plain cell loop."""
    LAYERS = ("rnn1",)

    def __init__(self, hidden_size: int = 3, p_dropout: float = 0.3,
                 k: int = 3, graph_kernel: str = "auto",
                 input_features: int = 3, needs_confidence: bool = True,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(hidden_size=hidden_size, p_dropout=p_dropout, k=k,
                         graph_kernel=graph_kernel, generator=generator,
                         input_features=input_features,
                         needs_confidence=needs_confidence, **kwargs)

    @property
    def output_type(self):
        return ClassificationModelOutputType.multiclass

    def _build_head(self) -> None:
        width = len(self.input_nodes) * self.hidden_size
        size1 = width // 2
        self.Dense_0 = nn.Linear(width, size1)
        self.Dense_1 = nn.Linear(size1, size1 // 2)
        self.Dense_2 = nn.Linear(size1 // 2, self.num_classes)

    def forward(self, x, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x[..., :self.input_features]
        if self._use_fused(x):
            h = self._layer_fused("rnn1", x.transpose(0, 1)).transpose(0, 1)
        else:
            h = self._layer_plain("rnn1", x)
        h = F.relu(dropout(h, self.p_dropout, training, generator))
        h = h[:, -1].reshape(h.shape[0], -1)
        for dense in (self.Dense_0, self.Dense_1):
            h = F.relu(dropout(dense(h), self.p_dropout, training, generator))
        return self.Dense_2(h)


class _GCNBestPaperBase(ClassificationModel):
    """What the two GCN classifiers share: the unnormalised skeleton
    adjacency with self loops, dropout 0.5, the seeded flax-family init
    and the head (reference ``gnn/gcn_best_paper.py:13-59``, IEEE
    8917118): node features reshaped to coordinate pairs, averaged over
    the frames and the pairs, then over the pair's two coordinates, and a
    Dense layer from the J joints to one binary logit. The graph products
    are dense (J, J) matmuls."""
    P_DROPOUT = 0.5

    def __init__(self, generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        adj = self.input_nodes.get_adjacency_matrix(normalized=False,
                                                    self_loops=True)
        self.register_buffer("adj", torch.from_numpy(np.asarray(
            adj, np.float32)), persistent=False)
        self._build()
        for name, p in self.named_parameters():
            if name.endswith(".bias"):
                nn.init.zeros_(p)
            else:
                lecun_normal_(p, generator)

    @property
    def output_type(self):
        return ClassificationModelOutputType.binary

    def _build(self) -> None:
        raise NotImplementedError

    def _propagate(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x over the joint axis of (..., J, C)."""
        return torch.matmul(self.adj.to(x.dtype), x)

    def _head(self, h: torch.Tensor, dense: nn.Linear) -> torch.Tensor:
        B, L, J = h.shape[:3]
        h = h.reshape(B, L, J, -1, 2).mean(dim=(1, 3)).mean(dim=-1)  # (B, J)
        return dense(h)


class GCNBestPaper(_GCNBestPaperBase):
    """Two GCN convolutions (64, then 32 features; ReLU after dropout) on
    the (x, y) coordinates, then the shared head."""

    def _build(self) -> None:
        self.Dense_0 = nn.Linear(2, 64)
        self.Dense_1 = nn.Linear(64, 32)
        self.Dense_2 = nn.Linear(len(self.input_nodes), 1)

    def forward(self, x, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        h = x[..., :2]
        for dense in (self.Dense_0, self.Dense_1):
            h = F.relu(dropout(dense(self._propagate(h)), self.P_DROPOUT,
                               training, generator))
        return self._head(h, self.Dense_2)


class GCNBestPaperTransformer(_GCNBestPaperBase):
    """A GCN convolution (64 features) and one head of attention over the
    skeleton graph (32 features: queries, keys and values by Dense layers,
    the logits of non-edges masked to -1e9), then the shared head
    (reference ``gnn/gcn_best_paper_transformer.py``)."""
    ATTENTION = 32

    def _build(self) -> None:
        self.Dense_0 = nn.Linear(2, 64)
        self.Dense_1 = nn.Linear(64, self.ATTENTION)   # queries
        self.Dense_2 = nn.Linear(64, self.ATTENTION)   # keys
        self.Dense_3 = nn.Linear(64, self.ATTENTION)   # values
        self.Dense_4 = nn.Linear(len(self.input_nodes), 1)

    def forward(self, x, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        h = self.Dense_0(self._propagate(x[..., :2]))
        h = F.relu(dropout(h, self.P_DROPOUT, training, generator))
        q, k, v = self.Dense_1(h), self.Dense_2(h), self.Dense_3(h)
        logits = torch.matmul(q, k.transpose(-1, -2)) \
            / float(np.sqrt(self.ATTENTION))
        logits = torch.where(self.adj > 0, logits,
                             torch.full_like(logits, -1e9))
        h = torch.matmul(torch.softmax(logits, dim=-1), v)
        h = F.relu(dropout(h, self.P_DROPOUT, training, generator))
        return self._head(h, self.Dense_4)
