"""The frame recurrences of the graph-convolutional GRU and LSTM layers of
the classification GNNs (``models/classification/gnn.py``) and of the dense
LSTM (``models/rnn.py``) as CUDA entries (a forward and a hand-written
backward each), with their plain PyTorch versions and the autograd
wrappers.

They replace the four TPU kernels of the JAX package's
``ops/pallas/fused_graph_gru.py`` (``_fwd_kernel``, ``_bwd_kernel``,
``_lstm_fwd_kernel``, ``_lstm_bwd_kernel``). The input-side graph
convolutions of a layer do not depend on the carry, so the caller computes
them for the whole clip (``xg``, both biases folded in); only the
hidden-side products and the gating run here, frame after frame. On an H100
operations bound the graph scans: at B=256, L=16, J=26, H=128, k=2 a GRU
layer's forward is 22.3 GFLOP against 0.22 GB of traffic (``ops/flops.py``).

Layouts are the natural ones (the TPU's interleaved slabs and Kronecker
constants are not carried over): ``xg`` is (L, B, J, G H), frame-major, with
G = 3 gates z|r|h for the GRU and 4 gates i|f|c|o for the LSTM; ``cheb``
holds the Chebyshev matrices T_1 .. T_{k-1} of the (J, J) graph operator,
(k - 1, J, J) (T_0 = I is implied; k = 1 takes an empty (0, J, J) tensor);
hidden-side weights are (H, k G' H) with columns ordered by Chebyshev order
n, then gate, as the TPU kernels take them. The outputs are every frame's
hidden (and cell) state, (L, B, J, H).

Routes on the card:
- the GRU (rows 10, 11): ``csrc/fused_graph_gru.cu``, 3xTF32 tensor-core
  products; its training forward (``keep``) writes the residuals its
  backward reads (:class:`GRUResiduals`): z | r | h~ and both expanded
  operands of every frame. It reads the weights as the caller holds them.
- the LSTM at k = 1 (no graph term: a dense LSTM over the B J rows; the
  case J = 1 is ``models/rnn.py``'s), where :func:`dense_lstm_plan` takes
  the width (H <= 64): ``csrc/fused_dense_lstm.cu``, the weights resident
  in registers, 3xTF32 tensor-core products; its training
  forward keeps the activated gates, so its backward recomputes nothing.
  It reads the weight as given or as the transpose of a contiguous (4H, H)
  tensor (a stacked ``nn.Linear`` weight), without a copy.
- the LSTM otherwise (the graph form: k >= 2, or wider H):
  ``csrc/fused_graph_gru.cu``'s LSTM kernels, in float32 on the GRU's
  tensor-core design (3xTF32 products, the caller's weight read in place;
  at k = 1 a stacked weight's transpose is copied once per call,
  ``w.contiguous()``), in bf16 on kernels of their own (bf16 tensor-core
  products, the weight held in shared memory across frames where it fits,
  split over a cluster of two thread blocks at GConvLSTM's layer, read in
  place as given or as a stacked weight's transpose:
  :func:`graph_lstm_bf16_plan`); its training forward (``keep``) writes
  the residuals its backward reads (:class:`LSTMResiduals`): the activated
  gates and the expanded operand of every frame.
The route is chosen from the shape before any launch, never because a
launch failed.

Every entry takes float32 or bf16 (xg, the graph matrices and the weights in
one dtype; the ``_bf16`` C entries), as the JAX kernels do with bf16
inputs: in bf16 the products' operands are rounded to bf16 where the JAX
kernels round one (the carry, r h, the backward's cotangents da) and the
graph terms (T_n h, and the transposed products' outputs P_n that the
graph applies to, which the JAX kernels' other order does not form) to
TF32, so that one TF32 product is exact, but the LSTM forward's T_n h,
which its bf16 kernel takes as two bf16 parts (hi + lo, 16 significant
bits: :func:`~.tensors.round_bf16x2`); the sums, the carries and the
gating stay float32. The kernels store ys, cs, dxg and the weight
gradients in bf16, the kept gates and expanded operands sa / sb in
float32 (the LSTM's sa with its graph columns rounded to TF32, which dW's
one TF32 pass reads exactly). The plain versions round where the kernels round
(:func:`~.tensors.round_bf16`, :func:`~.tensors.round_tf32`,
straight-through, on float32 arithmetic), so that both give the same
values up to the order of float32 sums; autograd of a bf16 plain version
returns gradients in bf16.

The wrappers launch the kernels for CUDA tensors and run the plain version
(and autograd of it) for CPU tensors; there is no fallback from one to the
other. The serving forwards are the ``torch.library`` ops
``pv2c::graph_gru_scan_fwd``, ``pv2c::graph_lstm_scan_fwd`` and
``pv2c::dense_lstm_scan_fwd``, each one node of an exported program.
``graph_gru_scan_cuda_fwd.launches`` etc. count entry calls (and
``.bf16_launches`` those in bf16); an entry is a fixed sequence of launches
(forward: 1; backward: 3), described in the sources.
"""
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import cuda_build
from .cuda_build import INT as _INT, PTR as _PTR
from .tensors import round_bf16, round_bf16x2, round_tf32

_SOURCE = cuda_build.CSRC / "fused_graph_gru.cu"
_DENSE_SOURCE = cuda_build.CSRC / "fused_dense_lstm.cu"
_SIGNATURES = {
    "pv2c_graph_gru_scan_fwd": [_PTR] * 8 + [_INT] * 5 + [_PTR],
    "pv2c_graph_gru_scan_bwd": [_PTR] * 11 + [_INT] * 5 + [_PTR],
    "pv2c_graph_lstm_scan_fwd": [_PTR] * 7 + [_INT] * 5 + [_PTR],
    "pv2c_graph_lstm_scan_bwd": [_PTR] * 10 + [_INT] * 5 + [_PTR],
    "pv2c_graph_scan_part_floats": [_INT] * 6,
    "pv2c_graph_gru_plan": [_INT] * 5 + [_PTR],
    "pv2c_graph_lstm_plan": [_INT] * 5 + [_PTR],
    "pv2c_graph_gru_scan_fwd_bf16": [_PTR] * 9 + [_INT] * 5 + [_PTR],
    "pv2c_graph_gru_scan_bwd_bf16": [_PTR] * 11 + [_INT] * 5 + [_PTR],
    "pv2c_graph_lstm_scan_fwd_bf16": [_PTR] * 3 + [_INT] + [_PTR] * 4
    + [_INT] * 5 + [_PTR],
    "pv2c_graph_lstm_scan_bwd_bf16": [_PTR] * 2 + [_INT] + [_PTR] * 8
    + [_INT] * 5 + [_PTR],
    "pv2c_graph_lstm_bf16_plan": [_INT] * 5 + [_PTR],
}
_DENSE_SIGNATURES = {
    "pv2c_dense_lstm_plan": [_INT] * 4 + [_PTR],
    "pv2c_dense_lstm_scan_fwd": [_PTR, _PTR, _INT] + [_PTR] * 3 + [_INT] * 4
    + [_PTR],
    "pv2c_dense_lstm_part_floats": [_INT] * 4,
    "pv2c_dense_lstm_scan_bwd": [_PTR, _INT] + [_PTR] * 8 + [_INT] * 4
    + [_PTR],
}
_DENSE_SIGNATURES.update({
    f"{name}_bf16": _DENSE_SIGNATURES[name]
    for name in ("pv2c_dense_lstm_scan_fwd", "pv2c_dense_lstm_scan_bwd")})
GRU_GATES, LSTM_GATES = 3, 4
#: the dtypes of the scans (one a call); the kept gates are float32 in both
SCAN_DTYPES = (torch.float32, torch.bfloat16)
#: the GRU forward's widest weight ring: a narrower one parks z outside
#: shared memory (in bf16, in a float32 scratch)
GRU_WIDE_RING = 256


def cheb_matrices(op: np.ndarray, k: int) -> np.ndarray:
    """T_1(op) .. T_{k-1}(op), the Chebyshev polynomials of the (J, J)
    graph operator (T_1 = op, T_n = 2 op T_{n-1} - T_{n-2}), stacked as
    (k - 1, J, J) float32; the recurrence runs in float64. T_0 = I is
    implied; k = 1 gives an empty (0, J, J) array."""
    op = np.asarray(op, np.float64)
    ts = [np.eye(op.shape[0]), op]
    for _ in range(max(0, k - 2)):
        ts.append(2.0 * op @ ts[-1] - ts[-2])
    return np.stack(ts[:max(k, 1)])[1:].astype(np.float32)


def _check_scan(xg: torch.Tensor, cheb: torch.Tensor, weights, gates: int,
                dtype: Optional[torch.dtype] = None
                ) -> Tuple[int, int, int, int, int]:
    """Shapes and types of a scan call; returns (L, B, J, H, k).
    ``weights``: ((name, tensor, gates in its group), ...). The tensors are
    in one of SCAN_DTYPES; with ``dtype`` given, ``xg`` is a backward's kept
    gates (float32) and cheb and the weights are in ``dtype``."""
    if xg.ndim != 4 or xg.shape[-1] % gates:
        raise ValueError(f"xg must be (L, B, J, {gates} H), got "
                         f"{tuple(xg.shape)}")
    L, B, J, GH = xg.shape
    H = GH // gates
    if cheb.ndim != 3 or tuple(cheb.shape[1:]) != (J, J):
        raise ValueError(f"cheb must be (k - 1, {J}, {J}), got "
                         f"{tuple(cheb.shape)}")
    k = cheb.shape[0] + 1
    if L < 1:
        raise ValueError("a scan needs at least one frame")
    for name, w, group in weights:
        if tuple(w.shape) != (H, k * group * H):
            raise ValueError(f"{name} must be ({H}, {k * group * H}), got "
                             f"{tuple(w.shape)}")
    if dtype is not None and xg.dtype != torch.float32:
        raise TypeError(f"the kept gates are float32, got {xg.dtype}")
    dtype = xg.dtype if dtype is None else dtype
    for t in (cheb, *(w for _, w, _ in weights)):
        if dtype not in SCAN_DTYPES or t.dtype != dtype:
            raise TypeError(f"the graph scans run in float32 or bf16, all "
                            f"tensors in one dtype; got {t.dtype} beside "
                            f"{dtype}")
        if t.device != xg.device:
            raise ValueError(f"tensors on {t.device} and {xg.device}")
    return L, B, J, H, k


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _arithmetic(dtype: torch.dtype):
    """How a plain version computes in ``dtype``: (widen, operand,
    graph_term). bf16: float32 arithmetic on the widened values, each
    product operand rounded to bf16 and each graph term to TF32 where the
    kernels round them (straight-through); float32: all the identity."""
    if dtype == torch.bfloat16:
        return (lambda t: t.float()), round_bf16, round_tf32
    return _same, _same, _same


def _graph_apply(cheb: torch.Tensor, hw: torch.Tensor, width: int
                 ) -> torch.Tensor:
    """sum_n T_n hw[..., n-th block of ``width`` columns] over n = 0 ..
    k - 1 on (B, J, k width) ``hw``."""
    out = hw[..., :width]
    for n in range(1, cheb.shape[0] + 1):
        out = out + torch.einsum(
            "ij,bjc->bic", cheb[n - 1], hw[..., n * width:(n + 1) * width])
    return out


def graph_gru_scan_reference(xg: torch.Tensor, cheb: torch.Tensor,
                             wzr: torch.Tensor, wh: torch.Tensor
                             ) -> torch.Tensor:
    """The plain PyTorch version of the GRU scan: a loop over frames.
    xg (L, B, J, 3H), cheb (k-1, J, J), wzr (H, k 2H), wh (H, k H) ->
    ys (L, B, J, H); in bf16 the output of
    :func:`graph_gru_scan_keep_reference`."""
    L, B, J, H, _ = _check_scan(xg, cheb, (("wzr", wzr, 2), ("wh", wh, 1)),
                                GRU_GATES)
    if xg.dtype == torch.bfloat16:
        return graph_gru_scan_keep_reference(xg, cheb, wzr, wh)[0]
    h = xg.new_zeros((B, J, H))
    ys = []
    for t in range(L):
        zr = torch.sigmoid(xg[t, ..., :2 * H]
                           + _graph_apply(cheb, h @ wzr, 2 * H))
        z, r = zr[..., :H], zr[..., H:]
        ht = torch.tanh(xg[t, ..., 2 * H:]
                        + _graph_apply(cheb, (r * h) @ wh, H))
        h = z * h + (1.0 - z) * ht
        ys.append(h)
    return torch.stack(ys)


class GRUResiduals(NamedTuple):
    """What the GRU's training forward keeps for its backward: ``gates``
    (L, B, J, 3H), z | r | h~ of every frame; ``sa`` and ``sb``
    (L B J, k H), every frame's expanded operands of h_prev and of
    r h_prev in the kernels' unit-major column order (:func:`_expand`)."""
    gates: torch.Tensor
    sa: torch.Tensor
    sb: torch.Tensor


def _expand(cheb: torch.Tensor, h: torch.Tensor, operand=_same,
            graph_term=_same) -> torch.Tensor:
    """The expanded operand of the GRU kernels: (B, J, H) -> (B, J, k H),
    column u k + n = (T_n h)[..., u] (unit-major), so that the caller's
    (H, k N) weight read as ``w.reshape(k H, N)`` multiplies it (its row
    u k + n is row u of W_n). ``operand`` rounds h and ``graph_term`` each
    T_n h as the bf16 kernels do."""
    h = operand(h)
    return torch.stack([h] + [graph_term(torch.einsum("ij,bjc->bic", t, h))
                              for t in cheb], dim=-1).flatten(-2)


def _graph_apply_t(cheb: torch.Tensor, p: torch.Tensor, graph_term=_same
                   ) -> torch.Tensor:
    """The cotangent of :func:`_expand`'s source from that of its output:
    (B, J, k H) unit-major -> sum_n T_n^T p_n, (B, J, H); ``graph_term``
    rounds each p_n (n >= 1) as the bf16 kernels do."""
    p = p.unflatten(-1, (-1, cheb.shape[0] + 1))
    out = p[..., 0]
    for n in range(1, cheb.shape[0] + 1):
        out = out + torch.einsum("ji,bjc->bic", cheb[n - 1],
                                 graph_term(p[..., n]))
    return out


def graph_gru_scan_keep_reference(xg: torch.Tensor, cheb: torch.Tensor,
                                  wzr: torch.Tensor, wh: torch.Tensor
                                  ) -> Tuple[torch.Tensor, GRUResiduals]:
    """The plain version of the GRU's training forward: the scan through
    the expanded operands and the weights as the kernel reads them,
    -> ``(ys, GRUResiduals)``. In bf16 (:func:`_arithmetic`) the carry
    stays float32, the expanded operands are rounded, and ys is returned in
    bf16, the gates and sa / sb in float32."""
    L, B, J, H, k = _check_scan(xg, cheb, (("wzr", wzr, 2), ("wh", wh, 1)),
                                GRU_GATES)
    dtype = xg.dtype
    widen, operand, term = _arithmetic(dtype)
    xg, cheb, wzr, wh = (widen(t) for t in (xg, cheb, wzr, wh))
    wzr_v, wh_v = wzr.reshape(k * H, 2 * H), wh.reshape(k * H, H)
    h = xg.new_zeros((B, J, H))
    ys, gates, sa, sb = [], [], [], []
    for t in range(L):
        a = _expand(cheb, h, operand, term)
        zr = torch.sigmoid(xg[t, ..., :2 * H] + a @ wzr_v)
        z, r = zr[..., :H], zr[..., H:]
        b = _expand(cheb, r * h, operand, term)
        ht = torch.tanh(xg[t, ..., 2 * H:] + b @ wh_v)
        h = z * h + (1.0 - z) * ht
        ys.append(h)
        gates.append(torch.cat([z, r, ht], dim=-1))
        sa.append(a)
        sb.append(b)

    def rows(ops):
        return torch.stack(ops).reshape(L * B * J, k * H)
    return torch.stack(ys).to(dtype), GRUResiduals(
        torch.stack(gates), rows(sa), rows(sb))


def _check_residuals(res, L: int, B: int, J: int, H: int, k: int) -> None:
    """Shapes of a :class:`GRUResiduals` or :class:`LSTMResiduals`: the
    gates (L, B, J, G H), each expanded operand (L B J, k H)."""
    gates = GRU_GATES if isinstance(res, GRUResiduals) else LSTM_GATES
    for name, t in res._asdict().items():
        want = (L, B, J, gates * H) if name == "gates" else (L * B * J, k * H)
        if tuple(t.shape) != want:
            raise ValueError(f"residual {name} must be {want}, got "
                             f"{tuple(t.shape)}")


def graph_gru_scan_bwd_reference(cheb: torch.Tensor, wzr: torch.Tensor,
                                 wh: torch.Tensor, res: GRUResiduals,
                                 dys: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The plain version of the GRU's backward from the training forward's
    residuals, frame by frame in reverse as the kernel runs it: two
    transposed products a frame (da_h Wh^T, then [da_z | da_r] Wzr^T, the
    weights read as ``w.reshape(k H, N)``), nothing of the forward
    recomputed, then dW = S^T da over all rows -> ``(dxg, dwzr, dwh)``,
    each in its primal's shape and dtype. In bf16 the cotangents da are
    rounded to bf16 and the transposed products' outputs that the graph
    applies to to TF32, as product operands; dh stays float32."""
    L, B, J, H = dys.shape
    k = cheb.shape[0] + 1
    _check_residuals(res, L, B, J, H, k)
    KH = k * H
    dtype = dys.dtype
    widen, operand, term = _arithmetic(dtype)
    cheb, dys = widen(cheb), widen(dys)
    wzr_v, wh_v = widen(wzr).reshape(KH, 2 * H), widen(wh).reshape(KH, H)
    sa = res.sa.reshape(L, B, J, KH)
    sb = res.sb.reshape(L, B, J, KH)
    dh = dys.new_zeros((B, J, H))
    dxg = []
    for t in reversed(range(L)):
        z, r, ht = res.gates[t].split(H, dim=-1)
        h = sa[t, ..., ::k]
        dh = dh + dys[t]
        da_z = operand(dh * (h - ht) * z * (1.0 - z))
        da_h = operand(dh * (1.0 - z) * (1.0 - ht * ht))
        drh = _graph_apply_t(cheb, da_h @ wh_v.t(), term)
        da_r = operand(drh * h * r * (1.0 - r))
        dh = dh * z + drh * r + _graph_apply_t(
            cheb, torch.cat([da_z, da_r], dim=-1) @ wzr_v.t(), term)
        dxg.append(torch.cat([da_z, da_r, da_h], dim=-1))
    dxg = torch.stack(dxg[::-1])
    flat = dxg.reshape(L * B * J, 3 * H)
    dwzr = sa.reshape(-1, KH).t() @ flat[:, :2 * H]
    dwh = sb.reshape(-1, KH).t() @ flat[:, 2 * H:]
    return (dxg.to(dtype), dwzr.reshape(wzr.shape).to(dtype),
            dwh.reshape(wh.shape).to(dtype))


def graph_lstm_scan_reference(xg: torch.Tensor, cheb: torch.Tensor,
                              w: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the LSTM scan. xg (L, B, J, 4H) in gate
    order i|f|c|o, cheb (k-1, J, J), w (H, k 4H) -> (ys, cs), each
    (L, B, J, H); in bf16 those of
    :func:`graph_lstm_scan_keep_reference`."""
    L, B, J, H, _ = _check_scan(xg, cheb, (("w", w, 4),), LSTM_GATES)
    if xg.dtype == torch.bfloat16:
        return graph_lstm_scan_keep_reference(xg, cheb, w)[:2]
    h = xg.new_zeros((B, J, H))
    c = xg.new_zeros((B, J, H))
    ys, cs = [], []
    for t in range(L):
        acts = xg[t] + _graph_apply(cheb, h @ w, 4 * H)
        i = torch.sigmoid(acts[..., :H])
        f = torch.sigmoid(acts[..., H:2 * H])
        g = torch.tanh(acts[..., 2 * H:3 * H])
        o = torch.sigmoid(acts[..., 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        cs.append(c)
    return torch.stack(ys), torch.stack(cs)


def _check_dense(xg: torch.Tensor, w: torch.Tensor,
                 dtype: Optional[torch.dtype] = None
                 ) -> Tuple[int, int, int, int]:
    """Shapes and types of a dense scan call (k = 1); returns (L, B, J,
    H). ``dtype``: as :func:`_check_scan`'s (``xg`` the kept gates)."""
    J = xg.shape[2] if xg.ndim == 4 else 1
    return _check_scan(xg, w.new_zeros((0, J, J)), (("w", w, 4),),
                       LSTM_GATES, dtype)[:4]


class LSTMResiduals(NamedTuple):
    """What the graph-form LSTM's training forward keeps for its backward:
    ``gates`` (L, B, J, 4H), the activated i | f | g | o of every frame;
    ``sa`` (L B J, k H), every frame's expanded operand of h_prev in the
    kernels' unit-major column order (:func:`_expand`)."""
    gates: torch.Tensor
    sa: torch.Tensor


def graph_lstm_scan_keep_reference(xg: torch.Tensor, cheb: torch.Tensor,
                                   w: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              LSTMResiduals]:
    """The plain version of the LSTM's training forward: the scan through
    the expanded operand and the weight as the kernels read it, ``w
    .reshape(k H, 4H)`` -> ``(ys, cs, LSTMResiduals)``. In bf16
    (:func:`_arithmetic`) h and c stay float32, the expanded operand is
    rounded (h to bf16, each graph term to two bf16 parts), ys and cs are
    returned in bf16, the gates and sa in float32, sa's graph columns
    rounded to TF32."""
    L, B, J, H, k = _check_scan(xg, cheb, (("w", w, 4),), LSTM_GATES)
    dtype = xg.dtype
    widen, operand, kept_term = _arithmetic(dtype)
    term = round_bf16x2 if dtype == torch.bfloat16 else _same
    xg, cheb, w = widen(xg), widen(cheb), widen(w)
    w_v = w.reshape(k * H, 4 * H)
    h = xg.new_zeros((B, J, H))
    c = xg.new_zeros((B, J, H))
    ys, cs, gates, sa = [], [], [], []
    for t in range(L):
        a = _expand(cheb, h, operand, term)
        acts = xg[t] + a @ w_v
        i, f, o = (torch.sigmoid(acts[..., n * H:(n + 1) * H])
                   for n in (0, 1, 3))
        g = torch.tanh(acts[..., 2 * H:3 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        cs.append(c)
        gates.append(torch.cat([i, f, g, o], dim=-1))
        sa.append(torch.cat([a.unflatten(-1, (H, k))[..., :1],
                             kept_term(a.unflatten(-1, (H, k))[..., 1:])],
                            dim=-1).flatten(-2))
    return torch.stack(ys).to(dtype), torch.stack(cs).to(dtype), \
        LSTMResiduals(torch.stack(gates),
                      torch.stack(sa).reshape(L * B * J, k * H))


def dense_lstm_scan_keep_reference(xg: torch.Tensor, w: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The plain version of the dense LSTM's training forward (k = 1): xg
    (L, B, J, 4H), w (H, 4H) -> ``(ys, cs, gates)``, the graph form's
    without its expanded operand (at k = 1 it is ys a frame back, which the
    dense backward reads in place)."""
    J = _check_dense(xg, w)[2]
    ys, cs, res = graph_lstm_scan_keep_reference(xg, xg.new_zeros((0, J, J)),
                                                 w)
    return ys, cs, res.gates


def _lstm_reverse(cheb: torch.Tensor, w_v: torch.Tensor, gates: torch.Tensor,
                  cs: torch.Tensor, dys: torch.Tensor,
                  dcs: Optional[torch.Tensor], operand=_same,
                  graph_term=_same) -> torch.Tensor:
    """The LSTM's reverse scan from the kept gates and cs, frame by frame
    as the kernels run it: the gating backward with dc carried (plus
    ``dcs`` where the caller used cs), then one transposed product a frame,
    dh = sum_n T_n^T (da W^T)_n (``w_v`` the (k H, 4H) weight), nothing of
    the forward recomputed -> dxg (L, B, J, 4H). ``operand`` rounds da and
    ``graph_term`` the products' outputs that the graph applies to, as the
    bf16 kernels do."""
    L, B, J, H = dys.shape
    dh_next = dys.new_zeros((B, J, H))
    dc_next = dys.new_zeros((B, J, H))
    das = []
    for t in reversed(range(L)):
        i, f, g, o = gates[t].split(H, dim=-1)
        dh = dys[t] + dh_next
        tc = torch.tanh(cs[t])
        dc = dh * o * (1.0 - tc * tc) + dc_next
        if dcs is not None:
            dc = dc + dcs[t]
        c_prev = cs[t - 1] if t > 0 else torch.zeros_like(dc)
        da = operand(torch.cat([dc * g * i * (1.0 - i),
                                dc * c_prev * f * (1.0 - f),
                                dc * i * (1.0 - g * g),
                                dh * tc * o * (1.0 - o)], dim=-1))
        dc_next = dc * f
        dh_next = _graph_apply_t(cheb, da @ w_v.t(), graph_term)
        das.append(da)
    return torch.stack(das[::-1])


def graph_lstm_scan_bwd_reference(cheb: torch.Tensor, w: torch.Tensor,
                                  res: LSTMResiduals, cs: torch.Tensor,
                                  dys: torch.Tensor,
                                  dcs: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the graph-form LSTM's backward from the
    training forward's residuals and cs (:func:`_lstm_reverse`, the weight
    read as ``w.reshape(k H, 4H)``), then dW = S^T dxg over all rows ->
    ``(dxg, dw)``, dw in w's shape, both in dys's dtype (bf16: rounded as
    the kernels round)."""
    L, B, J, H = dys.shape
    k = cheb.shape[0] + 1
    _check_residuals(res, L, B, J, H, k)
    dtype = dys.dtype
    widen, operand, term = _arithmetic(dtype)
    dxg = _lstm_reverse(widen(cheb), widen(w).reshape(k * H, 4 * H),
                        res.gates, widen(cs), widen(dys),
                        None if dcs is None else widen(dcs), operand, term)
    dw = res.sa.t() @ dxg.reshape(-1, 4 * H)
    return dxg.to(dtype), dw.reshape(w.shape).to(dtype)


def dense_lstm_scan_bwd_reference(w: torch.Tensor, gates: torch.Tensor,
                                  ys: torch.Tensor, cs: torch.Tensor,
                                  dys: torch.Tensor,
                                  dcs: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dense LSTM's backward from the training
    forward's gates, ys and cs: :func:`_lstm_reverse` at k = 1, then dW =
    sum over frames t >= 1 of ys[t-1]^T da[t] -> ``(dxg, dw)``, both in
    dys's dtype (bf16: rounded as the kernels round)."""
    L, B, J, H = dys.shape
    dtype = dys.dtype
    widen, operand, _ = _arithmetic(dtype)
    dxg = _lstm_reverse(gates.new_zeros((0, J, J)), widen(w), gates,
                        widen(cs), widen(dys),
                        None if dcs is None else widen(dcs), operand)
    dw = widen(ys)[:-1].reshape(-1, H).t() @ dxg[1:].reshape(-1, 4 * H)
    return dxg.to(dtype), dw.to(dtype)


def _library():
    return cuda_build.load_library(_SOURCE, _SIGNATURES)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _part(lib, device, L, B, J, H, k, gates) -> torch.Tensor:
    floats = lib.pv2c_graph_scan_part_floats(L, B, J, H, k, gates)
    if floats < 0:
        cuda_build.check_launch(-floats, "pv2c_graph_scan_part_floats")
    return torch.empty(floats, dtype=torch.float32, device=device)


def graph_gru_plan(B: int, J: int, H: int, k: int, backward: bool = False,
                   device=None) -> Tuple[int, int, int]:
    """How the GRU scan (or its reverse scan) is launched at this shape on
    a CUDA device: (clips a thread block, the weight ring's widest tile,
    shared memory bytes), zeros where one clip does not fit (the launch
    then raises)."""
    return _scan_plan("pv2c_graph_gru_plan", 3, B, J, H, k, bool(backward),
                      _device_index(device))


@functools.lru_cache(maxsize=None)
def _scan_plan(entry: str, size: int, B: int, J: int, H: int, k: int,
               backward: bool, index: int) -> Tuple[int, ...]:
    plan = torch.zeros(size, dtype=torch.int32)
    with torch.cuda.device(index):
        err = getattr(_library(), entry)(B, J, H, k, int(backward),
                                         plan.data_ptr())
    cuda_build.check_launch(err, entry)
    return tuple(int(v) for v in plan)


def _device_index(device) -> int:
    index = torch.device("cuda" if device is None else device).index
    return torch.cuda.current_device() if index is None else index


def _float32(device):
    return functools.partial(torch.empty, dtype=torch.float32, device=device)


def graph_gru_scan_cuda_fwd(xg: torch.Tensor, cheb: torch.Tensor,
                            wzr: torch.Tensor, wh: torch.Tensor,
                            keep: bool = False):
    """Launch the GRU scan on float32 or bf16 contiguous CUDA tensors -> ys
    (L, B, J, H) in xg's dtype; with ``keep``, ``(ys, GRUResiduals)`` for
    :func:`graph_gru_scan_cuda_bwd` (the gates, sa and sb float32). Adds
    one to ``graph_gru_scan_cuda_fwd.launches`` per call (and,
    for bf16, to ``.bf16_launches``)."""
    L, B, J, H, k = _check_scan(xg, cheb, (("wzr", wzr, 2), ("wh", wh, 1)),
                                GRU_GATES)
    device = cuda_build.check_cuda_tensors(
        "graph_gru_scan_cuda_fwd", dtypes=(xg.dtype,), xg=xg, cheb=cheb,
        wzr=wzr, wh=wh)
    bf16 = xg.dtype == torch.bfloat16
    empty = functools.partial(torch.empty, dtype=xg.dtype, device=device)
    ys = empty((L, B, J, H))
    kept = _float32(device)
    res = GRUResiduals(kept((L, B, J, 3 * H)), kept((L * B * J, k * H)),
                       kept((L * B * J, k * H))) if keep else None
    if ys.numel():
        outs = (ys, *(res if keep else (None,) * 3))
        ptrs = [None if t is None else t.data_ptr() for t in outs]
        with torch.cuda.device(device):
            lib = _library()
            if bf16:   # z's scratch where the plan's ring is the narrow one
                narrow = graph_gru_plan(B, J, H, k, False,
                                        device)[1] != GRU_WIDE_RING
                zpark = _float32(device)(B * J * H) if narrow else None
                err = lib.pv2c_graph_gru_scan_fwd_bf16(
                    xg.data_ptr(), cheb.data_ptr(), wzr.data_ptr(),
                    wh.data_ptr(), *ptrs,
                    None if zpark is None else zpark.data_ptr(),
                    L, B, J, H, k, _stream(device))
            else:
                err = lib.pv2c_graph_gru_scan_fwd(
                    xg.data_ptr(), cheb.data_ptr(), wzr.data_ptr(),
                    wh.data_ptr(), *ptrs, L, B, J, H, k, _stream(device))
        cuda_build.check_launch(err, "pv2c_graph_gru_scan_fwd")
        graph_gru_scan_cuda_fwd.launches += 1
        graph_gru_scan_cuda_fwd.bf16_launches += bf16
    return (ys, res) if keep else ys


cuda_build.counted("graph_gru_scan", graph_gru_scan_cuda_fwd, bf16=True)


def graph_gru_scan_cuda_bwd(cheb: torch.Tensor, wzr: torch.Tensor,
                            wh: torch.Tensor, res: GRUResiduals,
                            dys: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Launch the GRU scan's backward on float32 or bf16 contiguous CUDA
    tensors: the graph matrices, the weights, the residuals of
    ``graph_gru_scan_cuda_fwd(..., keep=True)`` and the cotangent dys
    (L, B, J, H) -> ``(dxg, dwzr, dwh)``, each in its primal's shape and
    dys's dtype. Adds one to ``graph_gru_scan_cuda_bwd.launches`` per call
    (and, for bf16, to ``.bf16_launches``)."""
    if dys.ndim != 4:
        raise ValueError(f"dys must be (L, B, J, H), got {tuple(dys.shape)}")
    L, B, J, H = dys.shape
    k = cheb.shape[0] + 1
    _check_scan(res.gates, cheb, (("wzr", wzr, 2), ("wh", wh, 1)), GRU_GATES,
                dys.dtype)
    _check_residuals(res, L, B, J, H, k)
    device = cuda_build.check_cuda_tensors(
        "graph_gru_scan_cuda_bwd", dtypes=(dys.dtype,), dys=dys, cheb=cheb,
        wzr=wzr, wh=wh)
    cuda_build.check_cuda_tensors("graph_gru_scan_cuda_bwd", **res._asdict())
    bf16 = dys.dtype == torch.bfloat16
    dxg = torch.empty(res.gates.shape, dtype=dys.dtype, device=device)
    if not dys.numel():
        return dxg.zero_(), torch.zeros_like(wzr), torch.zeros_like(wh)
    dwzr, dwh = torch.empty_like(wzr), torch.empty_like(wh)
    lib = _library()
    with torch.cuda.device(device):
        part = _part(lib, device, L, B, J, H, k, GRU_GATES)
        entry = lib.pv2c_graph_gru_scan_bwd_bf16 if bf16 \
            else lib.pv2c_graph_gru_scan_bwd
        err = entry(
            cheb.data_ptr(), wzr.data_ptr(), wh.data_ptr(),
            res.gates.data_ptr(), res.sa.data_ptr(), res.sb.data_ptr(),
            dys.data_ptr(), dxg.data_ptr(), part.data_ptr(),
            dwzr.data_ptr(), dwh.data_ptr(), L, B, J, H, k,
            _stream(device))
    cuda_build.check_launch(err, "pv2c_graph_gru_scan_bwd")
    graph_gru_scan_cuda_bwd.launches += 1
    graph_gru_scan_cuda_bwd.bf16_launches += bf16
    return dxg, dwzr, dwh


cuda_build.counted("graph_gru_scan_bwd", graph_gru_scan_cuda_bwd, bf16=True)


def graph_lstm_plan(B: int, J: int, H: int, k: int, backward: bool = False,
                    device=None) -> Tuple[int, int, int, int]:
    """How the graph-form LSTM scan (or its reverse scan) is launched at
    this shape on a CUDA device: (clips a thread block, the weight ring's
    widest tile, shared memory bytes, rows of a block tile: 64, or 16 in
    the few-rows tiling), zeros where one clip does not fit (the launch
    then raises)."""
    return _scan_plan("pv2c_graph_lstm_plan", 4, B, J, H, k, bool(backward),
                      _device_index(device))


def graph_lstm_bf16_plan(B: int, J: int, H: int, k: int,
                         backward: bool = False, device=None
                         ) -> Tuple[int, ...]:
    """How the bf16 graph-form LSTM kernels launch at this shape on a CUDA
    device: (clips a cluster, thread blocks a cluster (1, or 2 where the
    forward splits the weight's units over a cluster), 1 where the weight
    stays in shared memory across frames and 0 where it streams, units a
    pass (backward: weight rows a pass), m16 tiles of an item's rows,
    shared memory bytes, thread blocks), zeros where one clip does not fit
    (the launch then raises). :func:`lstm_bf16_plan` is its copy."""
    return _scan_plan("pv2c_graph_lstm_bf16_plan", 7, B, J, H, k,
                      bool(backward), _device_index(device))


#: the bf16 LSTM kernels' constants (csrc/fused_graph_gru.cu): a thread
#: block's shared memory, its warps, a warp's items where their sums live
#: across weight tiles, a streamed weight tile's depth and the ring's
#: tiles, a bf16 row's padding
BF16_LSTM_SMEM, BF16_LSTM_WARPS, BF16_LSTM_ITEMS = 232448, 16, 2
BF16_LSTM_KT, BF16_LSTM_STAGES, BF16_LSTM_PAD = 64, 2, 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bf16_lstm_bytes(C: int, J: int, H: int, k: int, backward: bool,
                    resident: bool, up: int) -> int:
    """Shared memory of a bf16 LSTM kernel (the source's LstmBf16Fwd and
    LstmBf16Bwd): C clips a thread block, the weight resident or streamed,
    ``up`` units a pass (backward: weight rows a pass)."""
    R, Hp, pad = C * J, _round_up(H, 16), BF16_LSTM_PAD
    if not backward:
        lda, ldw = (2 * k - 1) * Hp + pad, 4 * _round_up(up, 8) + pad
        Jp = _round_up(J, 16)
        return (2 * R * lda
                + 2 * (k * Hp if resident
                       else BF16_LSTM_STAGES * BF16_LSTM_KT) * ldw
                + 2 * (k - 1) * Jp * (Jp + pad)
                + (0 if resident else 4 * R * H))
    C4, Jm = _round_up(4 * H, 16), _round_up(J, 16)
    ldp = _round_up(k * H, 32) + 4
    t = _round_up(4 * R * ldp + 4 * R * H, 16)
    w = _round_up(t + 4 * (k - 1) * Jm * (Jm + 4), 16)
    ldw = C4 + pad if resident else BF16_LSTM_KT + pad
    rows = _round_up(k * Hp, 32) if resident else BF16_LSTM_STAGES * up
    return w + 2 * rows * ldw + 2 * R * (C4 + pad)


def lstm_bf16_plan(B: int, J: int, H: int, k: int, backward: bool, sms: int,
                   clusters: int) -> Tuple[int, ...]:
    """The bf16 LSTM kernels' launch plan as the source computes it
    (``plan_lstm_bf16``) for a card of ``sms`` SMs running ``clusters``
    clusters of two at once: :func:`graph_lstm_bf16_plan`'s seven numbers.
    The forward holds the weight in one thread block where it fits, else
    over a cluster of two (H a multiple of 16), else streams it; the
    backward holds it where it fits, else streams it."""
    most = BF16_LSTM_WARPS * BF16_LSTM_ITEMS

    def mi(C):
        return 2 if C * J > 16 else 1

    def groups(C):
        return -(-C * J // (16 * mi(C)))

    def plan(C, ns, res, up):
        nbytes = bf16_lstm_bytes(C, J, H, k, backward, res, up)
        return (C, ns, int(res), up, mi(C), nbytes, -(-B // C) * ns)
    C1 = max(1, -(-B // sms))
    if backward:
        KB = _round_up(k * _round_up(H, 16), 32)
        if bf16_lstm_bytes(C1, J, H, k, True, True, 0) <= BF16_LSTM_SMEM:
            return plan(C1, 1, True, KB)
        for C in range(C1, 0, -1):
            for nt in range(min(KB, 32 * (most // groups(C))), 0, -32):
                if bf16_lstm_bytes(C, J, H, k, True, False, nt) \
                        <= BF16_LSTM_SMEM:
                    return plan(C, 1, False, nt)
        return (0,) * 7
    if groups(C1) * -(-H // 8) <= most and \
            bf16_lstm_bytes(C1, J, H, k, False, True, H) <= BF16_LSTM_SMEM:
        return plan(C1, 1, True, H)
    if H % 16 == 0 and clusters > 0:
        C = max(1, -(-B // clusters))
        if groups(C) * (H // 16) <= most and bf16_lstm_bytes(
                C, J, H, k, False, True, H // 2) <= BF16_LSTM_SMEM:
            return plan(C, 2, True, H // 2)
    for C in range(C1, 0, -1):
        for up in range(min(_round_up(H, 8), 8 * (most // groups(C))), 0,
                        -8):
            if bf16_lstm_bytes(C, J, H, k, False, False, up) \
                    <= BF16_LSTM_SMEM:
                return plan(C, 1, False, up)
    return (0,) * 7


def _lstm_weight(fn_name: str, w: torch.Tensor, bf16: bool) -> int:
    """How the graph-form kernels read w: 0 as given (contiguous); in bf16
    also 1, the transpose of a contiguous (k 4H, H) tensor, read in
    place. Anything else raises."""
    if bf16:
        return _weight_transposed(fn_name, w)
    if not w.is_contiguous():
        raise ValueError(f"{fn_name}: w must be contiguous")
    return 0


def graph_lstm_scan_cuda_fwd(xg: torch.Tensor, cheb: torch.Tensor,
                             w: torch.Tensor, keep: bool = False):
    """Launch the graph-form LSTM scan on float32 or bf16 CUDA tensors (w
    contiguous or, in bf16, the transpose of a contiguous (k 4H, H); the
    others contiguous) -> ``(ys, cs)``, each (L, B, J, H) in xg's dtype;
    with ``keep``, ``(ys, cs, LSTMResiduals)`` for
    :func:`graph_lstm_scan_cuda_bwd` (the gates and sa float32). Adds one
    to ``graph_lstm_scan_cuda_fwd.launches`` per call (and, for bf16, to
    ``.bf16_launches``)."""
    L, B, J, H, k = _check_scan(xg, cheb, (("w", w, 4),), LSTM_GATES)
    bf16 = xg.dtype == torch.bfloat16
    wt = _lstm_weight("graph_lstm_scan_cuda_fwd", w, bf16)
    device = cuda_build.check_cuda_tensors(
        "graph_lstm_scan_cuda_fwd", dtypes=(xg.dtype,), xg=xg, cheb=cheb,
        w=w.t() if wt else w)
    empty = functools.partial(torch.empty, dtype=xg.dtype, device=device)
    ys, cs = empty((L, B, J, H)), empty((L, B, J, H))
    res = LSTMResiduals(_float32(device)((L, B, J, 4 * H)),
                        _float32(device)((L * B * J, k * H))) if keep else None
    if ys.numel():
        lib = _library()
        kept = (t.data_ptr() for t in res) if keep else (None,) * 2
        with torch.cuda.device(device):
            if bf16:
                err = lib.pv2c_graph_lstm_scan_fwd_bf16(
                    xg.data_ptr(), cheb.data_ptr(), w.data_ptr(), wt,
                    ys.data_ptr(), cs.data_ptr(), *kept, L, B, J, H, k,
                    _stream(device))
            else:
                err = lib.pv2c_graph_lstm_scan_fwd(
                    xg.data_ptr(), cheb.data_ptr(), w.data_ptr(),
                    ys.data_ptr(), cs.data_ptr(), *kept, L, B, J, H, k,
                    _stream(device))
        cuda_build.check_launch(err, "pv2c_graph_lstm_scan_fwd")
        graph_lstm_scan_cuda_fwd.launches += 1
        graph_lstm_scan_cuda_fwd.bf16_launches += bf16
    return (ys, cs, res) if keep else (ys, cs)


cuda_build.counted("graph_lstm_scan", graph_lstm_scan_cuda_fwd, bf16=True)


def graph_lstm_scan_cuda_bwd(cheb: torch.Tensor, w: torch.Tensor,
                             res: LSTMResiduals, cs: torch.Tensor,
                             dys: torch.Tensor,
                             dcs: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the graph-form LSTM scan's backward on float32 or bf16
    contiguous CUDA tensors (w as :func:`graph_lstm_scan_cuda_fwd` takes
    it): the graph matrices, the weight, the residuals of
    ``graph_lstm_scan_cuda_fwd(..., keep=True)``, its cell states cs, the
    cotangent dys and, where the caller used cs, its cotangent dcs ->
    ``(dxg, dw)``, each in its primal's shape and dys's dtype (dw
    contiguous). Adds one to ``graph_lstm_scan_cuda_bwd.launches`` per call
    (and, for bf16, to ``.bf16_launches``)."""
    if dys.ndim != 4:
        raise ValueError(f"dys must be (L, B, J, H), got {tuple(dys.shape)}")
    L, B, J, H = dys.shape
    k = cheb.shape[0] + 1
    _check_scan(res.gates, cheb, (("w", w, 4),), LSTM_GATES, dys.dtype)
    _check_residuals(res, L, B, J, H, k)
    given = {"cs": cs, "dys": dys}
    if dcs is not None:
        given["dcs"] = dcs
    for name, t in given.items():
        if tuple(t.shape) != (L, B, J, H):
            raise ValueError(f"{name} must be {(L, B, J, H)}, got "
                             f"{tuple(t.shape)}")
    bf16 = dys.dtype == torch.bfloat16
    wt = _lstm_weight("graph_lstm_scan_cuda_bwd", w, bf16)
    device = cuda_build.check_cuda_tensors(
        "graph_lstm_scan_cuda_bwd", dtypes=(dys.dtype,), cheb=cheb,
        w=w.t() if wt else w, **given)
    cuda_build.check_cuda_tensors("graph_lstm_scan_cuda_bwd",
                                  gates=res.gates, sa=res.sa)
    dxg = torch.empty(res.gates.shape, dtype=dys.dtype, device=device)
    dw = torch.empty(tuple(w.shape), dtype=w.dtype, device=device)
    if not dys.numel():
        return dxg.zero_(), dw.zero_()
    lib = _library()
    with torch.cuda.device(device):
        part = _part(lib, device, L, B, J, H, k, LSTM_GATES)
        rest = (res.gates.data_ptr(), res.sa.data_ptr(), cs.data_ptr(),
                dys.data_ptr(), None if dcs is None else dcs.data_ptr(),
                dxg.data_ptr(), part.data_ptr(), dw.data_ptr(), L, B, J, H,
                k, _stream(device))
        if bf16:
            err = lib.pv2c_graph_lstm_scan_bwd_bf16(
                cheb.data_ptr(), w.data_ptr(), wt, *rest)
        else:
            err = lib.pv2c_graph_lstm_scan_bwd(cheb.data_ptr(), w.data_ptr(),
                                               *rest)
    cuda_build.check_launch(err, "pv2c_graph_lstm_scan_bwd")
    graph_lstm_scan_cuda_bwd.launches += 1
    graph_lstm_scan_cuda_bwd.bf16_launches += bf16
    return dxg, dw


cuda_build.counted("graph_lstm_scan_bwd", graph_lstm_scan_cuda_bwd, bf16=True)


def _dense_library():
    return cuda_build.load_library(_DENSE_SOURCE, _DENSE_SIGNATURES)


@functools.lru_cache(maxsize=None)
def _dense_plan(B: int, J: int, H: int, k: int, index: int
                ) -> Tuple[int, ...]:
    plan = torch.zeros(6, dtype=torch.int32)
    with torch.cuda.device(index):
        err = _dense_library().pv2c_dense_lstm_plan(B, J, H, k,
                                                    plan.data_ptr())
    cuda_build.check_launch(err, "pv2c_dense_lstm_plan")
    return tuple(int(v) for v in plan)


def dense_lstm_plan(B: int, J: int, H: int, k: int = 1, device=None
                    ) -> Tuple[int, ...]:
    """How the dense LSTM kernels are launched at this shape on a CUDA
    device: (forward rows a thread block, its shared memory bytes, its
    thread blocks, the same three of the backward), all zeros where the
    dense route does not take the shape (k != 1, or H > 64, where the
    weights no longer fit a thread's registers; the graph-form kernels run
    it then)."""
    return _dense_plan(B, J, H, k, _device_index(device))


def _weight_transposed(fn_name: str, w: torch.Tensor) -> int:
    """How the dense kernels read the weight: 0 for a contiguous (H, 4H)
    tensor, 1 for the transpose of a contiguous (4H, H) one (read in
    place); anything else raises."""
    if w.is_contiguous():
        return 0
    if w.t().is_contiguous():
        return 1
    raise ValueError(f"{fn_name}: w must be contiguous or the transpose of "
                     "a contiguous tensor")


def dense_lstm_scan_cuda_fwd(xg: torch.Tensor, w: torch.Tensor,
                             keep: bool = False):
    """Launch the dense LSTM scan (k = 1) on float32 or bf16 CUDA tensors:
    xg (L, B, J, 4H) contiguous, w (H, 4H) contiguous or the transpose of a
    contiguous (4H, H) -> ``(ys, cs)`` in xg's dtype; with ``keep`` ``(ys,
    cs, gates)`` (the gates float32) for :func:`dense_lstm_scan_cuda_bwd`.
    Raises where :func:`dense_lstm_plan` does not take the shape. Adds one
    to ``dense_lstm_scan_cuda_fwd.launches`` per call (and, for bf16, to
    ``.bf16_launches``)."""
    L, B, J, H = _check_dense(xg, w)
    wt = _weight_transposed("dense_lstm_scan_cuda_fwd", w)
    device = cuda_build.check_cuda_tensors(
        "dense_lstm_scan_cuda_fwd", dtypes=(xg.dtype,), xg=xg,
        w=w.t() if wt else w)
    bf16 = xg.dtype == torch.bfloat16
    empty = functools.partial(torch.empty, dtype=xg.dtype, device=device)
    ys, cs = empty((L, B, J, H)), empty((L, B, J, H))
    gates = _float32(device)((L, B, J, 4 * H)) if keep else None
    if ys.numel():
        lib = _dense_library()
        entry = lib.pv2c_dense_lstm_scan_fwd_bf16 if bf16 \
            else lib.pv2c_dense_lstm_scan_fwd
        with torch.cuda.device(device):
            err = entry(
                xg.data_ptr(), w.data_ptr(), wt, ys.data_ptr(), cs.data_ptr(),
                gates.data_ptr() if keep else None, L, B, J, H,
                _stream(device))
        cuda_build.check_launch(err, "pv2c_dense_lstm_scan_fwd")
        dense_lstm_scan_cuda_fwd.launches += 1
        dense_lstm_scan_cuda_fwd.bf16_launches += bf16
    return (ys, cs, gates) if keep else (ys, cs)


cuda_build.counted("dense_lstm_scan", dense_lstm_scan_cuda_fwd, bf16=True)


def dense_lstm_scan_cuda_bwd(w: torch.Tensor, gates: torch.Tensor,
                             ys: torch.Tensor, cs: torch.Tensor,
                             dys: torch.Tensor,
                             dcs: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dense LSTM scan's backward on float32 or bf16 CUDA
    tensors: the weight (as :func:`dense_lstm_scan_cuda_fwd` takes it), the
    ``keep`` forward's gates (float32), ys and cs, the cotangent dys and,
    where the caller used cs, its cotangent dcs -> ``(dxg, dw)`` in dys's
    dtype, dw (H, 4H) contiguous. Adds one to
    ``dense_lstm_scan_cuda_bwd.launches`` per call (and, for bf16, to
    ``.bf16_launches``)."""
    L, B, J, H = _check_dense(gates, w, dys.dtype)
    given = {"ys": ys, "cs": cs, "dys": dys}
    if dcs is not None:
        given["dcs"] = dcs
    for name, t in given.items():
        if tuple(t.shape) != (L, B, J, H):
            raise ValueError(f"{name} must be {(L, B, J, H)}, got "
                             f"{tuple(t.shape)}")
    wt = _weight_transposed("dense_lstm_scan_cuda_bwd", w)
    device = cuda_build.check_cuda_tensors(
        "dense_lstm_scan_cuda_bwd", dtypes=(dys.dtype,), w=w.t() if wt else w,
        **given)
    cuda_build.check_cuda_tensors("dense_lstm_scan_cuda_bwd", gates=gates)
    bf16 = dys.dtype == torch.bfloat16
    dw = torch.empty((H, 4 * H), dtype=dys.dtype, device=device)
    dxg = torch.empty(gates.shape, dtype=dys.dtype, device=device)
    if not ys.numel():
        return dxg.zero_(), dw.zero_()
    lib = _dense_library()
    with torch.cuda.device(device):
        floats = lib.pv2c_dense_lstm_part_floats(L, B, J, H)
        if floats < 0:
            cuda_build.check_launch(-floats, "pv2c_dense_lstm_part_floats")
        part = _float32(device)(floats)
        entry = lib.pv2c_dense_lstm_scan_bwd_bf16 if bf16 \
            else lib.pv2c_dense_lstm_scan_bwd
        err = entry(
            w.data_ptr(), wt, gates.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            dys.data_ptr(), None if dcs is None else dcs.data_ptr(),
            dxg.data_ptr(), part.data_ptr(), dw.data_ptr(), L, B, J, H,
            _stream(device))
    cuda_build.check_launch(err, "pv2c_dense_lstm_scan_bwd")
    dense_lstm_scan_cuda_bwd.launches += 1
    dense_lstm_scan_cuda_bwd.bf16_launches += bf16
    return dxg, dw


cuda_build.counted("dense_lstm_scan_bwd", dense_lstm_scan_cuda_bwd, bf16=True)


def _plain_backward(reference, inputs, cotangents):
    """Autograd of a plain version over fresh leaves of ``inputs``: the
    backward of the entries on CPU tensors. A ``None`` cotangent is that
    output unused."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        outs = reference(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        used = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
        return torch.autograd.grad([o for o, _ in used], leaves,
                                   [g for _, g in used])


def _check_device(name: str, t: torch.Tensor) -> bool:
    """True on the card, False on the CPU; any other device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


# The serving forwards as ``torch.library`` ops (one node each of an
# exported graph): the kernel on the card, the plain version on the CPU,
# the output shapes alone for fake tensors.

def _scan_outputs(xg: torch.Tensor, H: int) -> torch.Tensor:
    return xg.new_empty(tuple(xg.shape[:3]) + (H,))


@torch.library.custom_op("pv2c::graph_gru_scan_fwd", mutates_args=(),
                         device_types="cpu")
def graph_gru_scan_fwd_op(xg: torch.Tensor, cheb: torch.Tensor,
                          wzr: torch.Tensor, wh: torch.Tensor
                          ) -> torch.Tensor:
    """Row 10's serving entry: ``graph_gru_scan_cuda_fwd`` on the card,
    the plain version on the CPU."""
    return graph_gru_scan_reference(xg, cheb, wzr, wh)


@graph_gru_scan_fwd_op.register_kernel("cuda")
def _(xg, cheb, wzr, wh):
    return graph_gru_scan_cuda_fwd(xg, cheb, wzr, wh)


@graph_gru_scan_fwd_op.register_fake
def _(xg, cheb, wzr, wh):
    _check_scan(xg, cheb, (("wzr", wzr, 2), ("wh", wh, 1)), GRU_GATES)
    return _scan_outputs(xg, wh.shape[0])


@torch.library.custom_op("pv2c::graph_lstm_scan_fwd", mutates_args=(),
                         device_types="cpu")
def graph_lstm_scan_fwd_op(xg: torch.Tensor, cheb: torch.Tensor,
                           w: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 12's serving entry, graph form: ``graph_lstm_scan_cuda_fwd`` on
    the card, the plain version on the CPU."""
    return graph_lstm_scan_reference(xg, cheb, w)


@graph_lstm_scan_fwd_op.register_kernel("cuda")
def _(xg, cheb, w):
    return graph_lstm_scan_cuda_fwd(xg, cheb, w)


@graph_lstm_scan_fwd_op.register_fake
def _(xg, cheb, w):
    _check_scan(xg, cheb, (("w", w, 4),), LSTM_GATES)
    return _scan_outputs(xg, w.shape[0]), _scan_outputs(xg, w.shape[0])


@torch.library.custom_op("pv2c::dense_lstm_scan_fwd", mutates_args=(),
                         device_types="cpu")
def dense_lstm_scan_fwd_op(xg: torch.Tensor, w: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 12's serving entry, dense form (k = 1): ``dense_lstm_scan_cuda_fwd``
    on the card, the plain version on the CPU."""
    J = _check_dense(xg, w)[2]
    return graph_lstm_scan_reference(xg, xg.new_zeros((0, J, J)), w)


@dense_lstm_scan_fwd_op.register_kernel("cuda")
def _(xg, w):
    return dense_lstm_scan_cuda_fwd(xg, w)


@dense_lstm_scan_fwd_op.register_fake
def _(xg, w):
    _check_dense(xg, w)
    return _scan_outputs(xg, w.shape[0]), _scan_outputs(xg, w.shape[0])


class GraphGRUScan(torch.autograd.Function):
    """Kernel forward and kernel backward (CUDA), or the plain forward and
    autograd of it (CPU), as the JAX package's custom VJP. ``keep``: a
    gradient will be asked for, so the kernel forward keeps the residuals
    its backward reads; without it the forward is
    ``pv2c::graph_gru_scan_fwd``. The graph matrices get no gradient."""

    @staticmethod
    def forward(ctx, xg, cheb, keep, wzr, wh):
        ctx.fused = _check_device("graph_gru_scan", xg)
        if keep and ctx.fused:
            ys, res = graph_gru_scan_cuda_fwd(xg, cheb, wzr, wh, keep=True)
            ctx.save_for_backward(cheb, wzr, wh, *res)
            return ys
        if keep:
            ctx.save_for_backward(xg, cheb, wzr, wh)
        return graph_gru_scan_fwd_op(xg, cheb, wzr, wh)

    @staticmethod
    def backward(ctx, dys):
        saved = ctx.saved_tensors
        if ctx.fused:
            cheb, wzr, wh, *res = saved
            dxg, dwzr, dwh = graph_gru_scan_cuda_bwd(
                cheb, wzr, wh, GRUResiduals(*res), dys.contiguous())
        else:
            xg, cheb, wzr, wh = saved
            dxg, dwzr, dwh = _plain_backward(
                lambda a, b, c: graph_gru_scan_reference(a, cheb, b, c),
                (xg, wzr, wh), (dys,))
        return dxg, None, None, dwzr, dwh


class GraphLSTMScan(torch.autograd.Function):
    """As :class:`GraphGRUScan`, for the LSTM scan; both outputs (ys, cs)
    are differentiable. On the card k = 1 takes the dense kernels where
    :func:`dense_lstm_plan` takes the shape, else the graph-form kernels;
    with ``keep`` either training forward keeps its residuals (the dense
    one its gates). The bf16 graph-form kernels, like the dense ones, read
    a stacked weight's transpose in place; the float32 graph form copies
    it."""

    @staticmethod
    def forward(ctx, xg, cheb, keep, w):
        ctx.fused = _check_device("graph_lstm_scan", xg)
        L, B, J, H, k = _check_scan(xg, cheb, (("w", w, 4),), LSTM_GATES)
        ctx.dense = ctx.fused and k == 1 and \
            dense_lstm_plan(B, J, H, k, xg.device)[0] > 0
        ctx.set_materialize_grads(False)
        if not ctx.fused:
            if keep:
                ctx.save_for_backward(xg, cheb, w)
            return graph_lstm_scan_fwd_op(xg, cheb, w)
        if ctx.dense:
            if not (w.is_contiguous() or w.t().is_contiguous()):
                w = w.contiguous()
            if not keep:
                return dense_lstm_scan_fwd_op(xg, w)
            ys, cs, gates = dense_lstm_scan_cuda_fwd(xg, w, keep=True)
            ctx.save_for_backward(w, gates, ys, cs)
            return ys, cs
        if not (xg.dtype == torch.bfloat16 and w.t().is_contiguous()):
            w = w.contiguous()   # (bf16 reads a stacked weight's transpose)
        if not keep:
            return graph_lstm_scan_fwd_op(xg, cheb, w)
        ys, cs, res = graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)
        ctx.save_for_backward(cheb, w, cs, *res)
        return ys, cs

    @staticmethod
    def backward(ctx, dys, dcs):
        if dys is None and dcs is None:
            return None, None, None, None
        dcs = None if dcs is None else dcs.contiguous()
        if not ctx.fused:
            xg, cheb, w = ctx.saved_tensors
            dxg, dw = _plain_backward(
                lambda a, b: graph_lstm_scan_reference(a, cheb, b),
                (xg, w), (dys, dcs))
        elif ctx.dense:
            w, gates, ys, cs = ctx.saved_tensors
            dys = torch.zeros_like(ys) if dys is None else dys.contiguous()
            dxg, dw = dense_lstm_scan_cuda_bwd(w, gates, ys, cs, dys, dcs)
        else:
            cheb, w, cs, *res = ctx.saved_tensors
            dys = torch.zeros_like(cs) if dys is None else dys.contiguous()
            dxg, dw = graph_lstm_scan_cuda_bwd(cheb, w, LSTMResiduals(*res),
                                               cs, dys, dcs)
        return dxg, None, None, dw


def graph_gru_scan(xg: torch.Tensor, cheb: torch.Tensor, wzr: torch.Tensor,
                   wh: torch.Tensor) -> torch.Tensor:
    """The graph-GRU frame recurrence, fused: xg (L, B, J, 3H) input-side
    gate pre-activations (z|r|h, both biases folded in), cheb (k-1, J, J),
    wzr (H, k 2H) with columns (n, z|r), wh (H, k H) with columns by n ->
    every frame's hidden state (L, B, J, H), the carry starting at zero.
    Differentiable in xg, wzr and wh."""
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xg, wzr, wh))
    return GraphGRUScan.apply(xg.contiguous(), cheb.contiguous(), keep,
                              wzr.contiguous(), wh.contiguous())


def graph_lstm_scan(xg: torch.Tensor, cheb: torch.Tensor, w: torch.Tensor,
                    with_c: bool = False):
    """The graph-LSTM frame recurrence, fused: xg (L, B, J, 4H) (i|f|c|o,
    both biases folded in), cheb (k-1, J, J), w (H, k 4H) with columns
    (n, i|f|c|o) -> the hidden states (L, B, J, H), and with ``with_c`` the
    cell states as well, ``(ys, cs)``. J = 1 with an empty cheb is a dense
    LSTM over B rows. Differentiable in xg and w. The transpose of a
    contiguous (4H, H) w (a stacked ``nn.Linear`` weight) is read in place
    where the dense kernels take the shape, and by the bf16 graph-form
    kernels."""
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xg, w))
    ys, cs = GraphLSTMScan.apply(xg.contiguous(), cheb.contiguous(), keep, w)
    return (ys, cs) if with_c else ys
