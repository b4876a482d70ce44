"""Port parity for the graph-GRU and graph-LSTM scans, on the CPU: the
port's plain versions against the JAX package's Pallas kernels in interpret
mode (``ops/pallas/fused_graph_gru.py``: ``graph_gru_scan``,
``graph_lstm_scan``), forward and ``jax.vjp``, on the same numpy-seeded
inputs; the GRU's training forward with residuals and its backward from
them (the algorithm the CUDA kernels run) against the same, and the
graph-form LSTM's likewise; the Chebyshev matrices; the autograd wrappers'
CPU route; the weight layout both cells' kernels read; the dense LSTM's
training forward with gates and its backward from them (the algorithm of
``csrc/fused_dense_lstm.cu``) against the Pallas kernel at k = 1 and
``jax.vjp``; the LSTM wrapper's route and residuals; the FLOP and byte
counts; the CUDA wrappers refuse CPU tensors; the build
key follows the included header; and, on a CUDA card only, the kernels
against their plain versions.

The JAX kernels take the TPU's slab layout (4 clips interleaved under each
joint, Kronecker graph constants); the port takes (L, B, J, G H) and the
(k - 1, J, J) matrices, so the JAX side is wrapped in ``to_slabs`` /
``from_slabs`` here, inside the differentiated function.

Bars (``tests/ops/test_pallas_graph_gru.py``): forward atol 1e-5, each
gradient within 1e-4 of its largest magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.ops.pallas import fused_graph_gru as JG

from pedestrians_video_2_carla_torch.ops import cuda_build
from pedestrians_video_2_carla_torch.ops import flops as TF
from pedestrians_video_2_carla_torch.ops import fused_graph_gru as G
from pedestrians_video_2_carla_torch.skeletons.carla import CARLA_SKELETON
from .torch_threads import limit_torch_threads

limit_torch_threads()

J = 26
#: (B, L, H, k): B=6 pads to the TPU layout's multiple of 4 with two groups,
#: B=5 is ragged; k=2 and k=3 tell swapped column blocks apart; k=1 takes
#: no graph matrices
SHAPES = {"k2": (6, 5, 16, 2), "k3_h3": (5, 4, 3, 3), "k1": (5, 3, 16, 1)}
FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4


def _operator():
    return -CARLA_SKELETON.get_adjacency_matrix(normalized=True,
                                                self_loops=False)


def _inputs(cell, shape):
    """numpy-seeded (xg, weights..., cotangents...) of one case."""
    B, L, H, k = SHAPES[shape]
    rng = np.random.default_rng(sum(map(ord, cell + shape)))
    gates = 3 if cell == "gru" else 4

    def rnd(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)
    xg = rnd(L, B, J, gates * H)
    if cell == "gru":
        weights = (rnd(H, k * 2 * H, scale=H ** -0.5),
                   rnd(H, k * H, scale=H ** -0.5))
        cots = (rnd(L, B, J, H),)
    else:
        weights = (rnd(H, k * 4 * H, scale=H ** -0.5),)
        cots = (rnd(L, B, J, H), rnd(L, B, J, H))
    return xg, weights, cots


@functools.lru_cache(maxsize=None)
def _jax_scan(cell, shape):
    """One JAX call per case: the kernel's outputs in the port's layout and
    its ``jax.vjp`` gradients (LSTM: with the cell states' cotangent, and
    without)."""
    B, L, H, k = SHAPES[shape]
    xg, weights, cots = _inputs(cell, shape)
    a_ops = jnp.asarray(JG.kron_cheb_ops(_operator(), k))
    R = J * JG.BBR

    def to_port(ys):                        # (L, rows, H) -> (L, B, J, H)
        return jnp.swapaxes(JG.from_slabs(ys, B, J), 0, 1)

    def run(xg_, *ws):
        xs, _ = JG.to_slabs(jnp.swapaxes(xg_, 0, 1))
        bg = JG.pick_block_groups(xs.shape[1] // R)
        if cell == "gru":
            return (to_port(JG.graph_gru_scan(xs, a_ops, *ws, k, R, bg)),)
        ys, cs = JG.graph_lstm_scan(xs, a_ops, *ws, k, R, bg, True)
        return to_port(ys), to_port(cs)

    outs, vjp = jax.vjp(run, jnp.asarray(xg), *map(jnp.asarray, weights))
    grads = {"all": vjp(tuple(map(jnp.asarray, cots)))}
    if cell == "lstm":
        grads["ys_only"] = vjp((jnp.asarray(cots[0]),
                                jnp.zeros_like(outs[1])))
    return ([np.asarray(o) for o in outs],
            {name: [np.asarray(g) for g in gs] for name, gs in grads.items()})


def _port_reference(cell):
    if cell == "gru":
        return lambda xg, cheb, *ws: (G.graph_gru_scan_reference(
            xg, cheb, *ws),)
    return G.graph_lstm_scan_reference


def _cheb(k):
    return torch.from_numpy(G.cheb_matrices(_operator(), k))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_cheb_matrices_match_jax(k):
    op = _operator()
    ref = JG.cheb_matrices(op, k)
    out = G.cheb_matrices(op, k)
    assert out.shape == (k - 1, J, J) and out.dtype == np.float32
    for n in range(1, k):
        np.testing.assert_array_equal(out[n - 1], ref[n])
    np.testing.assert_array_equal(ref[0], np.eye(J, dtype=np.float32))


@pytest.mark.parametrize("cell,shape", [
    ("gru", "k2"), ("gru", "k3_h3"), ("gru", "k1"), ("lstm", "k2"),
    ("lstm", "k3_h3"), ("lstm", "k1")])
def test_plain_scan_matches_jax_kernel(cell, shape):
    xg, weights, _ = _inputs(cell, shape)
    outs = _port_reference(cell)(
        torch.from_numpy(xg), _cheb(SHAPES[shape][3]),
        *map(torch.from_numpy, weights))
    refs, _ = _jax_scan(cell, shape)
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        assert tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=FWD_ATOL)


def _scaled_close(got, ref, what):
    scale = float(np.max(np.abs(ref))) + 1e-6
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0,
                               atol=GRAD_ATOL, err_msg=what)


@pytest.mark.parametrize("cell,shape,cotangents", [
    ("gru", "k2", "all"), ("gru", "k3_h3", "all"), ("gru", "k1", "all"),
    ("lstm", "k2", "all"), ("lstm", "k2", "ys_only"),
    ("lstm", "k3_h3", "all"), ("lstm", "k1", "all")])
def test_scan_gradients_match_jax_vjp(cell, shape, cotangents):
    """The entries' gradients on the CPU (autograd of the plain versions,
    through the autograd wrappers) against ``jax.vjp`` of the Pallas
    backward: dxg, and every weight gradient."""
    xg, weights, cots = _inputs(cell, shape)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (xg, *weights)]
    cheb = _cheb(SHAPES[shape][3])
    if cell == "gru":
        outs = (G.graph_gru_scan(leaves[0], cheb, *leaves[1:]),)
    elif cotangents == "all":
        outs = G.graph_lstm_scan(leaves[0], cheb, leaves[1], with_c=True)
    else:
        outs = (G.graph_lstm_scan(leaves[0], cheb, leaves[1]),)
    grads = torch.autograd.grad(outs, leaves,
                                [torch.from_numpy(c) for c in
                                 cots[:len(outs)]])
    _, refs = _jax_scan(cell, shape)
    names = ("dxg", "dwzr", "dwh") if cell == "gru" else ("dxg", "dw")
    for name, g, r in zip(names, grads, refs[cotangents]):
        _scaled_close(g.numpy(), r, name)


@pytest.mark.parametrize("shape", ["k2", "k3_h3", "k1"])
def test_gru_residual_path_matches_jax(shape):
    """The GRU's plain training forward with residuals, and its plain
    backward from them (two transposed products a frame, nothing of the
    forward recomputed: the recurrence the CUDA kernels run), against the
    Pallas kernel and ``jax.vjp`` of it."""
    B, L, H, k = SHAPES[shape]
    xg, (wzr, wh), (dys,) = _inputs("gru", shape)
    t = torch.from_numpy
    cheb = _cheb(k)
    ys, res = G.graph_gru_scan_keep_reference(t(xg), cheb, t(wzr), t(wh))
    (ref_ys,), grads = _jax_scan("gru", shape)
    np.testing.assert_allclose(ys.numpy(), ref_ys, rtol=0, atol=FWD_ATOL)
    got = G.graph_gru_scan_bwd_reference(cheb, t(wzr), t(wh), res, t(dys))
    for name, g, r in zip(("dxg", "dwzr", "dwh"), got, grads["all"]):
        assert tuple(g.shape) == r.shape
        _scaled_close(g.numpy(), r, name)


def test_gru_residual_layout():
    """What the training forward keeps: z, r, h~ in (0, 1), (0, 1) and
    (-1, 1); sa the previous hidden state expanded (h and T_1 h, zero
    before the first frame), sb the same of r h, both k H columns wide,
    unit-major (column u k + n holds T_n's unit u)."""
    B, L, H, k = SHAPES["k2"]
    xg, (wzr, wh), _ = _inputs("gru", "k2")
    cheb = _cheb(k)
    ys, res = G.graph_gru_scan_keep_reference(
        torch.from_numpy(xg), cheb, torch.from_numpy(wzr),
        torch.from_numpy(wh))
    assert tuple(res.gates.shape) == (L, B, J, 3 * H)
    assert tuple(res.sa.shape) == tuple(res.sb.shape) == (L * B * J, k * H)
    z, r, ht = res.gates.split(H, dim=-1)
    assert bool(((z > 0) & (z < 1) & (r > 0) & (r < 1)).all())
    assert bool((ht.abs() < 1).all())
    sa = res.sa.reshape(L, B, J, k * H)
    sb = res.sb.reshape(L, B, J, k * H)
    assert not bool(sa[0].any())
    h_prev = ys[:-1]
    np.testing.assert_allclose(sa[1:, ..., 0::2].numpy(), h_prev.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        sa[1:, ..., 1::2].numpy(),
        torch.einsum("ij,lbjc->lbic", cheb[0], h_prev).numpy(), atol=1e-6)
    np.testing.assert_allclose(sb[1:, ..., 0::2].numpy(),
                               (r[1:] * h_prev).numpy(), atol=1e-6)


def _check_weight_layout(H, k, widths):
    """The (H, k N) weight as a (k H, N) row-major matrix, whose row u k + n
    is row u of W_n, times the expanded operand in unit-major order (column
    u k + n = T_n's unit u) is the scan's sum_n T_n (h W_n); the weight
    gradient S^T da comes out in the caller's layout."""
    rng = np.random.default_rng(H + k)
    cheb = _cheb(k)
    h = torch.from_numpy(rng.standard_normal((2, J, H)).astype(np.float32))
    expanded = G._expand(cheb, h)
    assert tuple(expanded.shape) == (2, J, k * H)
    for u in range(H):
        for n in range(k):
            want = h[..., u] if n == 0 else torch.einsum(
                "ij,bj->bi", cheb[n - 1], h[..., u])
            np.testing.assert_allclose(expanded[..., u * k + n].numpy(),
                                       want.numpy(), atol=1e-6)
    for N in widths:
        w = torch.from_numpy(rng.standard_normal((H, k * N)).astype(
            np.float32))
        view = w.reshape(k * H, N)
        for u in range(H):
            for n in range(k):
                assert torch.equal(view[u * k + n], w[u, n * N:(n + 1) * N])
        np.testing.assert_allclose((expanded @ view).numpy(),
                                   G._graph_apply(cheb, h @ w, N).numpy(),
                                   atol=1e-4)
        da = torch.from_numpy(rng.standard_normal((2, J, N)).astype(
            np.float32))
        grad = expanded.reshape(-1, k * H).t() @ da.reshape(-1, N)
        want = torch.autograd.grad(
            G._graph_apply(cheb, h @ w.requires_grad_(True), N), w, da)[0]
        np.testing.assert_allclose(grad.reshape(H, k * N).numpy(),
                                   want.numpy(), atol=1e-4)


@pytest.mark.parametrize("H,k", [(16, 2), (3, 3), (128, 1)])
def test_gru_kernel_weight_layouts(H, k):
    """The GRU kernels read both weights as the caller holds them
    (:func:`_check_weight_layout`, N = 2H and H)."""
    _check_weight_layout(H, k, (2 * H, H))


@pytest.mark.parametrize("H,k", [(16, 2), (3, 3), (128, 1)])
def test_lstm_kernel_weight_layouts(H, k):
    """The graph-form LSTM kernels read w (H, k 4H) as the caller holds it,
    ``w.reshape(k H, 4H)`` (:func:`_check_weight_layout`, N = 4H), where
    the earlier kernels took a restacked copy."""
    _check_weight_layout(H, k, (4 * H,))


def test_gru_autograd_keeps_residuals_only_for_a_gradient(monkeypatch):
    """The autograd wrapper asks the kernel route for the residuals only
    when a gradient will be asked for (the training forward); eval and
    ``torch.no_grad`` take the plain forward. Shown on CPU tensors with the
    kernel route forced and the CUDA entries swapped for their plain
    versions (the serving forward is the ``pv2c`` op, whose CUDA kernel is
    the entry without ``keep``)."""
    calls = []

    def fwd(xg, cheb, wzr, wh, keep=False):
        calls.append(keep)
        if keep:
            return G.graph_gru_scan_keep_reference(xg, cheb, wzr, wh)
        return G.graph_gru_scan_reference(xg, cheb, wzr, wh)
    monkeypatch.setattr(G, "_check_device", lambda name, t: True)
    monkeypatch.setattr(G, "graph_gru_scan_cuda_fwd", fwd)
    monkeypatch.setattr(G, "graph_gru_scan_fwd_op", fwd)
    monkeypatch.setattr(G, "graph_gru_scan_cuda_bwd",
                        G.graph_gru_scan_bwd_reference)
    xg, (wzr, wh), (dys,) = _inputs("gru", "k2")
    cheb = _cheb(2)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (xg, wzr, wh)]
    with torch.no_grad():
        G.graph_gru_scan(leaves[0], cheb, *leaves[1:])
    out = G.graph_gru_scan(leaves[0], cheb, *leaves[1:])
    assert calls == [False, True]
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dys))
    want = torch.autograd.grad(
        G.graph_gru_scan_reference(leaves[0], cheb, *leaves[1:]), leaves,
        torch.from_numpy(dys))
    for g, w in zip(got, want):
        _scaled_close(g.numpy(), w.numpy(), "gradient")


def test_dense_lstm_keep_forward_matches_jax():
    """The dense LSTM's plain training forward (k = 1): ys and cs against
    the Pallas kernel, and the gates it keeps equal to the activations of
    xg + ys[t-1] W from the kernel's own ys."""
    B, L, H, _ = SHAPES["k1"]
    xg, (w,), _ = _inputs("lstm", "k1")
    ys, cs, gates = G.dense_lstm_scan_keep_reference(torch.from_numpy(xg),
                                                     torch.from_numpy(w))
    (ref_ys, ref_cs), _ = _jax_scan("lstm", "k1")
    np.testing.assert_allclose(ys.numpy(), ref_ys, rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(cs.numpy(), ref_cs, rtol=0, atol=FWD_ATOL)
    assert tuple(gates.shape) == (L, B, J, 4 * H)
    h_prev = np.concatenate([np.zeros_like(ref_ys[:1]), ref_ys[:-1]])
    acts = xg + h_prev @ w
    sig = 1.0 / (1.0 + np.exp(-acts))
    want = np.concatenate([sig[..., :2 * H], np.tanh(acts[..., 2 * H:3 * H]),
                           sig[..., 3 * H:]], axis=-1)
    np.testing.assert_allclose(gates.numpy(), want, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("cotangents", ["all", "ys_only"])
def test_dense_lstm_backward_from_residuals_matches_jax_vjp(cotangents):
    """The dense LSTM's plain backward from the training forward's gates,
    ys and cs (one transposed product a frame, nothing of the forward
    recomputed, dW from ys shifted by a frame: the recurrence of its CUDA
    kernels) against ``jax.vjp`` of the Pallas kernel at k = 1, with the
    cell states' cotangent and without."""
    xg, (w,), (dys, dcs) = _inputs("lstm", "k1")
    t = torch.from_numpy
    ys, cs, gates = G.dense_lstm_scan_keep_reference(t(xg), t(w))
    got = G.dense_lstm_scan_bwd_reference(
        t(w), gates, ys, cs, t(dys), t(dcs) if cotangents == "all" else None)
    _, grads = _jax_scan("lstm", "k1")
    for name, g, r in zip(("dxg", "dw"), got, grads[cotangents]):
        assert tuple(g.shape) == r.shape
        _scaled_close(g.numpy(), r, name)


@pytest.mark.parametrize("shape", ["k2", "k3_h3", "k1"])
def test_lstm_keep_forward_matches_jax(shape):
    """The graph-form LSTM's plain training forward (the algorithm of its
    CUDA kernels): ys and cs against the Pallas kernel; the gates it keeps
    are the activations of xg + S W, with S the expanded operand it keeps
    (unit-major, the previous frame's hidden state, zero at frame 0)."""
    B, L, H, k = SHAPES[shape]
    xg, (w,), _ = _inputs("lstm", shape)
    cheb = _cheb(k)
    ys, cs, res = G.graph_lstm_scan_keep_reference(torch.from_numpy(xg),
                                                   cheb, torch.from_numpy(w))
    (ref_ys, ref_cs), _ = _jax_scan("lstm", shape)
    np.testing.assert_allclose(ys.numpy(), ref_ys, rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(cs.numpy(), ref_cs, rtol=0, atol=FWD_ATOL)
    assert tuple(res.gates.shape) == (L, B, J, 4 * H)
    assert tuple(res.sa.shape) == (L * B * J, k * H)
    sa = res.sa.reshape(L, B, J, k * H)
    assert not bool(sa[0].any())
    np.testing.assert_allclose(sa[1:, ..., ::k].numpy(), ref_ys[:-1],
                               rtol=0, atol=FWD_ATOL)
    acts = xg + sa.numpy() @ w.reshape(k * H, 4 * H)
    sig = 1.0 / (1.0 + np.exp(-acts))
    want = np.concatenate([sig[..., :2 * H], np.tanh(acts[..., 2 * H:3 * H]),
                           sig[..., 3 * H:]], axis=-1)
    np.testing.assert_allclose(res.gates.numpy(), want, rtol=0,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("shape", ["k2", "k3_h3", "k1"])
@pytest.mark.parametrize("cotangents", ["all", "ys_only"])
def test_lstm_backward_from_residuals_matches_jax_vjp(shape, cotangents):
    """The graph-form LSTM's plain backward from the training forward's
    residuals and cs (one transposed product a frame, then the transposed
    graph, nothing of the forward recomputed; dW = S^T dxg in the caller's
    layout) against ``jax.vjp`` of the Pallas kernel, with the cell states'
    cotangent and without."""
    xg, (w,), (dys, dcs) = _inputs("lstm", shape)
    t = torch.from_numpy
    cheb = _cheb(SHAPES[shape][3])
    _, cs, res = G.graph_lstm_scan_keep_reference(t(xg), cheb, t(w))
    got = G.graph_lstm_scan_bwd_reference(
        cheb, t(w), res, cs, t(dys), t(dcs) if cotangents == "all" else None)
    _, grads = _jax_scan("lstm", shape)
    for name, g, r in zip(("dxg", "dw"), got, grads[cotangents]):
        assert tuple(g.shape) == r.shape
        _scaled_close(g.numpy(), r, name)


def test_lstm_autograd_routes_and_keeps_gates_only_for_a_gradient(
        monkeypatch):
    """On the card (forced here on CPU tensors, the CUDA entries swapped
    for their plain versions) k = 1 takes the dense entries where the plan
    takes the shape, and k = 2, and k = 1 where the plan refuses the width,
    the graph-form entries. Either route keeps its residuals only when a
    gradient will be asked for, and its gradient is that of the plain scan;
    a stacked weight's transpose reaches the dense entry uncopied. The
    serving forwards are the ``pv2c`` ops, whose CUDA kernels are the
    entries without ``keep``."""
    calls = []

    def dense_fwd(xg, w, keep=False):
        calls.append(("dense", keep, w.is_contiguous()))
        ys, cs, gates = G.dense_lstm_scan_keep_reference(xg, w)
        return (ys, cs, gates) if keep else (ys, cs)

    def graph_fwd(xg, cheb, w, keep=False):
        calls.append(("graph", cheb.shape[0] + 1, keep))
        ys, cs, res = G.graph_lstm_scan_keep_reference(xg, cheb, w)
        return (ys, cs, res) if keep else (ys, cs)
    taken_h = []
    monkeypatch.setattr(G, "_check_device", lambda name, t: True)
    monkeypatch.setattr(G, "dense_lstm_plan", lambda B, J, H, k, device: (
        (16,) * 6 if k == 1 and H in taken_h else (0,) * 6))
    monkeypatch.setattr(G, "dense_lstm_scan_cuda_fwd", dense_fwd)
    monkeypatch.setattr(G, "dense_lstm_scan_cuda_bwd",
                        G.dense_lstm_scan_bwd_reference)
    monkeypatch.setattr(G, "graph_lstm_scan_cuda_fwd", graph_fwd)
    monkeypatch.setattr(G, "dense_lstm_scan_fwd_op", dense_fwd)
    monkeypatch.setattr(G, "graph_lstm_scan_fwd_op", graph_fwd)
    monkeypatch.setattr(G, "graph_lstm_scan_cuda_bwd",
                        G.graph_lstm_scan_bwd_reference)

    def grads_match(x, cheb, leaf, w, cots):
        outs = G.graph_lstm_scan(x, cheb, w, with_c=True)
        got = torch.autograd.grad(outs, (x, leaf), cots)
        want = torch.autograd.grad(G.graph_lstm_scan_reference(x, cheb, w),
                                   (x, leaf), cots)
        for g, r in zip(got, want):
            _scaled_close(g.numpy(), r.numpy(), "gradient")

    xg, (w,), (dys, dcs) = _inputs("lstm", "k1")
    H = w.shape[0]
    taken_h.append(H)
    cheb = _cheb(1)
    x = torch.from_numpy(xg).requires_grad_(True)
    stacked = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
    cots = (torch.from_numpy(dys), torch.from_numpy(dcs))
    with torch.no_grad():
        G.graph_lstm_scan(x, cheb, stacked.t())
    grads_match(x, cheb, stacked, stacked.t(), cots)
    assert calls == [("dense", False, False), ("dense", True, False)]

    calls.clear()
    taken_h.clear()                 # the plan refuses this width: graph form
    with torch.no_grad():
        G.graph_lstm_scan(x, cheb, stacked.t())
    grads_match(x, cheb, stacked, stacked.t(), cots)
    lx, (lw,), (ldy, ldc) = _inputs("lstm", "k2")
    lx, lw = (torch.from_numpy(a).requires_grad_(True) for a in (lx, lw))
    with torch.no_grad():
        G.graph_lstm_scan(lx, _cheb(2), lw)
    grads_match(lx, _cheb(2), lw, lw,
                (torch.from_numpy(ldy), torch.from_numpy(ldc)))
    assert calls == [("graph", 1, False), ("graph", 1, True),
                     ("graph", 2, False), ("graph", 2, True)]


def test_library_path_follows_an_included_header(tmp_path):
    """An edited ``.cuh`` that a source includes rebuilds that source."""
    header = G._SOURCE.parent / "mma_tf32.cuh"
    assert f'#include "{header.name}"' in G._SOURCE.read_text()
    src = tmp_path / G._SOURCE.name
    src.write_text(G._SOURCE.read_text())
    for included in cuda_build._local_headers(G._SOURCE):
        (tmp_path / included.name).write_text(included.read_text())
    first = cuda_build.library_path(src)
    assert first == cuda_build.library_path(G._SOURCE)
    (tmp_path / header.name).write_text(header.read_text() + "\n// edited\n")
    assert cuda_build.library_path(src) != first


def test_autograd_wrapper_equals_autograd_of_plain():
    """On CPU tensors the Functions are the plain versions, forward and
    backward, bit for bit."""
    xg, (wzr, wh), (dys,) = _inputs("gru", "k2")
    cheb = _cheb(2)

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (xg, wzr, wh)]
        out = fn(leaves[0], cheb, *leaves[1:])
        return out, torch.autograd.grad(out, leaves, torch.from_numpy(dys))
    out, got = grads(G.graph_gru_scan)
    ref_out, ref = grads(G.graph_gru_scan_reference)
    assert torch.equal(out, ref_out)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_dense_lstm_form_matches_a_plain_loop():
    """J = 1 with no graph matrices is a dense LSTM over the batch rows."""
    rng = np.random.default_rng(11)
    L, B, H = 4, 5, 8
    xg = torch.from_numpy(rng.standard_normal((L, B, 1, 4 * H)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((H, 4 * H)) * H ** -0.5).astype(
        np.float32))
    ys, cs = G.graph_lstm_scan(xg, xg.new_zeros((0, 1, 1)), w, with_c=True)
    h = c = torch.zeros(B, H)
    for t in range(L):
        i, f, g, o = (xg[t, :, 0] + h @ w).split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        np.testing.assert_allclose(ys[t, :, 0].numpy(), h.numpy(), atol=1e-6)
        np.testing.assert_allclose(cs[t, :, 0].numpy(), c.numpy(), atol=1e-6)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_shape_checks(cell):
    xg, weights, _ = _inputs(cell, "k2")
    xg, weights = torch.from_numpy(xg), [torch.from_numpy(w) for w in weights]
    entry = G.graph_gru_scan if cell == "gru" else G.graph_lstm_scan
    with pytest.raises(ValueError, match="must be"):   # k=3 graph, k=2 weights
        entry(xg, _cheb(3), *weights)
    with pytest.raises(ValueError, match="cheb"):
        entry(xg, torch.zeros(1, 5, 5), *weights)
    with pytest.raises(TypeError, match="float32"):
        entry(xg.double(), _cheb(2), *weights)


def test_flop_and_byte_counts():
    # B=256, L=16, J=26, H=128, k=2: the main path's layer
    rows = 256 * 16 * 26
    fwd = TF.graph_scan_flops("gru", 256, 16, 26, 128, 2)
    assert fwd == rows * (2 * 256 * 384 + 2 * 2 * 26 * 128)
    # the backward reads the gates from the training forward's residuals:
    # the hidden products twice (dh through da W^T, dW), the transposed
    # graph once per product (as the forward's graph term)
    assert TF.graph_scan_flops("gru", 256, 16, 26, 128, 2, backward=True) \
        == rows * (2 * 2 * 256 * 384 + 2 * 2 * 26 * 128)
    assert TF.graph_scan_bytes("gru", 256, 16, 26, 128, 2) \
        == 4 * (rows * 512 + 256 * 384 + 26 * 26)
    # the training forward also writes the residuals: gates 3H = 384 and
    # two expanded operands k H = 256 each a row
    assert TF.graph_scan_bytes("gru", 256, 16, 26, 128, 2, keep=True) \
        == 4 * (rows * (512 + 384 + 2 * 256) + 256 * 384 + 26 * 26)
    # the backward: residuals (896), dys (128) in, dxg (384) out a row;
    # the weights in and their gradients out
    assert TF.graph_scan_bytes("gru", 256, 16, 26, 128, 2, backward=True) \
        == 4 * (rows * (896 + 128 + 384) + 2 * (256 * 384 + 26 * 26))
    # the graph-form LSTM's backward reads the gates its training forward
    # kept: the products twice (dh through da W^T, dW), the transposed graph
    # once (its forward's count)
    assert TF.graph_scan_flops("lstm", 256, 16, 26, 128, 2) \
        == rows * (2 * 256 * 512 + 2 * 26 * 128)
    assert TF.graph_scan_flops("lstm", 256, 16, 26, 128, 2, backward=True) \
        == rows * (2 * 2 * 256 * 512 + 2 * 26 * 128)
    # its training forward writes the gates (4H = 512) and the expanded
    # operand (k H = 256) a row beside xg (512) in, ys and cs (256) out;
    # its backward reads the gates, the operand, cs and dys (512 + 256 +
    # 128 + 128), with dcs 128 more, and writes dxg (512)
    weights = 256 * 512 + 26 * 26
    assert TF.graph_scan_bytes("lstm", 256, 16, 26, 128, 2) \
        == 4 * (rows * 768 + weights)
    assert TF.graph_scan_bytes("lstm", 256, 16, 26, 128, 2, keep=True) \
        == 4 * (rows * (768 + 768) + weights)
    assert TF.graph_scan_bytes("lstm", 256, 16, 26, 128, 2, backward=True,
                               with_dcs=True) \
        == 4 * (rows * (512 + 256 + 128 + 128 + 128 + 512) + 2 * weights)
    # the dense LSTM form: no graph term
    assert TF.graph_scan_flops("lstm", 256, 16, 1, 64, 1) \
        == 256 * 16 * 2 * 64 * 256
    assert TF.graph_scan_bytes("lstm", 4, 2, 1, 8, 1, backward=True,
                               with_dcs=True) \
        == 4 * (8 * (64 + 32) + 2 * 8 * 32)
    # its backward, as every route's, reads the kept gates: the products
    # twice (dh through da W^T, dW); the dense route reads ys where the graph
    # form reads the expanded operand, as many floats at k = 1; the dense
    # training forward writes the gates, 4H a row, the graph form's also
    # the operand, k H
    assert TF.graph_scan_flops("lstm", 256, 16, 1, 64, 1, backward=True) \
        == 256 * 16 * 2 * 2 * 64 * 256
    assert TF.graph_scan_bytes("lstm", 4, 2, 1, 8, 1, backward=True,
                               with_dcs=True, dense=True) \
        == 4 * (8 * (64 + 32) + 2 * 8 * 32)
    assert TF.graph_scan_bytes("lstm", 4, 2, 1, 8, 1, keep=True, dense=True) \
        == 4 * (8 * (32 + 16 + 32) + 8 * 32)
    assert TF.graph_scan_bytes("lstm", 4, 2, 1, 8, 1, keep=True) \
        == 4 * (8 * (32 + 16 + 32 + 8) + 8 * 32)


def test_cuda_wrappers_refuse_cpu_tensors():
    xg, (wzr, wh), (dys,) = _inputs("gru", "k2")
    t = torch.from_numpy
    cheb = _cheb(2)
    with pytest.raises(ValueError, match="CUDA"):
        G.graph_gru_scan_cuda_fwd(t(xg), cheb, t(wzr), t(wh))
    _, res = G.graph_gru_scan_keep_reference(t(xg), cheb, t(wzr), t(wh))
    with pytest.raises(ValueError, match="CUDA"):
        G.graph_gru_scan_cuda_bwd(cheb, t(wzr), t(wh), res, t(dys))
    lx, (w,), (dy, dc) = _inputs("lstm", "k2")
    with pytest.raises(ValueError, match="CUDA"):
        G.graph_lstm_scan_cuda_fwd(t(lx), cheb, t(w), keep=True)
    _, lcs, lres = G.graph_lstm_scan_keep_reference(t(lx), cheb, t(w))
    with pytest.raises(ValueError, match="CUDA"):
        G.graph_lstm_scan_cuda_bwd(cheb, t(w), lres, lcs, t(dy), t(dc))
    dx, (dw_,), (ddy, ddc) = _inputs("lstm", "k1")
    with pytest.raises(ValueError, match="CUDA"):
        G.dense_lstm_scan_cuda_fwd(t(dx), t(dw_))
    ys, cs, gates = G.dense_lstm_scan_keep_reference(t(dx), t(dw_))
    with pytest.raises(ValueError, match="CUDA"):
        G.dense_lstm_scan_cuda_bwd(t(dw_), gates, ys, cs, t(ddy), t(ddc))
    with pytest.raises(ValueError, match="transpose"):   # neither layout
        G.dense_lstm_scan_cuda_fwd(t(dx), torch.zeros(2 * dw_.shape[0],
                                                      dw_.shape[1])[::2])
    for fn in (G.graph_gru_scan_cuda_fwd, G.graph_gru_scan_cuda_bwd,
               G.graph_lstm_scan_cuda_fwd, G.graph_lstm_scan_cuda_bwd,
               G.dense_lstm_scan_cuda_fwd, G.dense_lstm_scan_cuda_bwd):
        assert fn.launches == 0


def test_kernel_source_is_packaged_and_keyed():
    assert G._SOURCE.exists() and G._SOURCE.suffix == ".cu"
    path = cuda_build.library_path(G._SOURCE)
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("fused_graph_gru-")
    for src, signatures in ((G._SOURCE, G._SIGNATURES),
                            (G._DENSE_SOURCE, G._DENSE_SIGNATURES)):
        assert cuda_build.library_path(src).name.startswith(src.stem + "-")
        source = src.read_text()
        assert "atomicAdd" not in source
        for name in signatures:
            assert f"int {name}(" in source


# -- on a CUDA card only -----------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py makes the same "
                    "checks on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_scan_matches_plain(cuda_device, cell, shape):
    xg, weights, cots = _inputs(cell, shape)
    cheb = _cheb(SHAPES[shape][3]).to(cuda_device)
    leaves = [torch.from_numpy(a).to(cuda_device).requires_grad_(True)
              for a in (xg, *weights)]
    cots = [torch.from_numpy(c).to(cuda_device) for c in cots]
    if cell == "gru":
        outs = (G.graph_gru_scan(leaves[0], cheb, *leaves[1:]),)
    else:
        outs = G.graph_lstm_scan(leaves[0], cheb, leaves[1], with_c=True)
    refs = _port_reference(cell)(leaves[0], cheb, *leaves[1:])
    for out, ref in zip(outs, refs):
        assert float((out - ref).abs().max()) <= FWD_ATOL
    got = torch.autograd.grad(outs, leaves, cots)
    want = torch.autograd.grad(refs, leaves, cots)
    for g, r in zip(got, want):
        _scaled_close(g.cpu().numpy(), r.cpu().numpy(), "gradient")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_gru_keep_forward_matches_plain(cuda_device, shape):
    """The training forward kernel's outputs and residuals against the
    plain forward with residuals."""
    xg, weights, _ = _inputs("gru", shape)
    cheb = _cheb(SHAPES[shape][3]).to(cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (xg, *weights)]
    ys, res = G.graph_gru_scan_cuda_fwd(args[0], cheb, *args[1:], keep=True)
    ref_ys, ref_res = G.graph_gru_scan_keep_reference(args[0], cheb,
                                                      *args[1:])
    for got, want in zip((ys, *res), (ref_ys, *ref_res)):
        assert float((got - want).abs().max()) <= FWD_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_gru_backward_from_residuals_matches_plain(cuda_device, shape):
    """The backward kernel from the training forward kernel's residuals
    against the plain backward from the same residuals; the same bits
    twice."""
    xg, weights, (dys,) = _inputs("gru", shape)
    cheb = _cheb(SHAPES[shape][3]).to(cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (xg, *weights)]
    dys = torch.from_numpy(dys).to(cuda_device)
    _, res = G.graph_gru_scan_cuda_fwd(args[0], cheb, *args[1:], keep=True)
    got = G.graph_gru_scan_cuda_bwd(cheb, *args[1:], res, dys)
    again = G.graph_gru_scan_cuda_bwd(cheb, *args[1:], res, dys)
    want = G.graph_gru_scan_bwd_reference(cheb, *args[1:], res, dys)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _scaled_close(g.cpu().numpy(), w.cpu().numpy(), "gradient")


#: (B, L, J, H, k) past the main path's widths: hidden 256 and k=3 with
#: hidden 128 (one clip a thread block), hidden 320 (the reverse scan on
#: the 128-column weight ring); hidden 448 for the forward alone (its
#: 128-column ring; the reverse scan does not fit there)
CUDA_WIDE_SHAPES = [(4, 3, J, 256, 2), (4, 3, J, 128, 3), (2, 3, J, 320, 2)]
CUDA_WIDE_FORWARD_SHAPES = [(2, 3, J, 448, 2)]


def _wide_case(shape, device):
    B, L, _, H, k = shape
    rng = np.random.default_rng(H + k)

    def rnd(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(
            np.float32)).to(device)
    return (rnd(L, B, J, 3 * H), _cheb(k).to(device),
            rnd(H, k * 2 * H, scale=H ** -0.5), rnd(H, k * H, scale=H ** -0.5),
            rnd(L, B, J, H))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_WIDE_SHAPES + CUDA_WIDE_FORWARD_SHAPES)
def test_cuda_gru_wide_shapes_match_plain(cuda_device, shape):
    """The GRU kernels at widths past the main path's: the forward (and,
    where it fits, the backward) against the plain versions."""
    B, L, _, H, k = shape
    xg, cheb, wzr, wh, dys = _wide_case(shape, cuda_device)
    ys, res = G.graph_gru_scan_cuda_fwd(xg, cheb, wzr, wh, keep=True)
    ref_ys, ref_res = G.graph_gru_scan_keep_reference(xg, cheb, wzr, wh)
    for got, want in zip((ys, *res), (ref_ys, *ref_res)):
        assert float((got - want).abs().max()) <= FWD_ATOL
    if shape in CUDA_WIDE_FORWARD_SHAPES:
        assert G.graph_gru_plan(B, J, H, k, backward=True)[0] == 0
        return
    got = G.graph_gru_scan_cuda_bwd(cheb, wzr, wh, res, dys)
    want = G.graph_gru_scan_bwd_reference(cheb, wzr, wh, res, dys)
    for g, w in zip(got, want):
        _scaled_close(g.cpu().numpy(), w.cpu().numpy(), "gradient")


#: (L, B, J, H) of the dense LSTM kernels on the card: the classifier's
#: dense shape (B=256, L=16, H=64), a ragged B, k = 1 at J = 26, a width
#: that pads to 8 units
CUDA_DENSE_SHAPES = [(16, 256, 1, 64), (16, 253, 1, 64), (4, 5, 26, 64),
                     (3, 7, 1, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_DENSE_SHAPES)
def test_cuda_dense_lstm_matches_plain(cuda_device, shape):
    """The dense LSTM kernels against their plain versions: the training
    forward (ys, cs, gates), and the backward from its residuals with and
    without the cell states' cotangent, the same bits twice; the weight
    read as given and as a stacked weight's transpose."""
    L, B, J_, H = shape
    rng = np.random.default_rng(L * B + H)

    def rnd(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(
            np.float32)).to(cuda_device)
    xg, w = rnd(L, B, J_, 4 * H), rnd(H, 4 * H, scale=H ** -0.5)
    dys, dcs = rnd(L, B, J_, H), rnd(L, B, J_, H)
    assert G.dense_lstm_plan(B, J_, H)[0] > 0
    refs = G.dense_lstm_scan_keep_reference(xg, w)
    for weight in (w, w.t().contiguous().t()):
        outs = G.dense_lstm_scan_cuda_fwd(xg, weight, keep=True)
        for got, want in zip(outs, refs):
            assert float((got - want).abs().max()) <= FWD_ATOL
        for d in (dcs, None):
            ys, cs, gates = outs
            got = G.dense_lstm_scan_cuda_bwd(weight, gates, ys, cs, dys, d)
            again = G.dense_lstm_scan_cuda_bwd(weight, gates, ys, cs, dys, d)
            want = G.dense_lstm_scan_bwd_reference(w, refs[2], refs[0],
                                                   refs[1], dys, d)
            for g, a, r in zip(got, again, want):
                assert torch.equal(g, a)
                _scaled_close(g.cpu().numpy(), r.cpu().numpy(), "gradient")


@pytest.mark.cuda
def test_cuda_dense_route_boundary(cuda_device):
    """H = 64 is the widest the dense kernels take; H = 65 runs on the
    graph-form kernels, through the same entry."""
    assert G.dense_lstm_plan(256, 1, 64)[0] > 0
    assert G.dense_lstm_plan(256, 1, 65) == (0,) * 6
    assert G.dense_lstm_plan(256, 1, 64, k=2) == (0,) * 6


#: (B, L, J, H, k) of the graph-form LSTM kernels past the file's shapes:
#: the few-rows tiling (J = 1, H = 128), the 64-column reverse-scan ring
#: (H = 266, k = 2), and, forward alone, the narrow tiling (H = 532, k = 2)
CUDA_LSTM_WIDE_SHAPES = [(6, 3, 1, 128, 1), (4, 3, J, 266, 2)]
CUDA_LSTM_WIDE_FORWARD_SHAPES = [(3, 2, J, 532, 2)]


def _lstm_case(shape, device):
    B, L, J_, H, k = shape
    rng = np.random.default_rng(H + k)

    def rnd(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(
            np.float32)).to(device)
    cheb = (_cheb(k) if J_ == J else torch.zeros(k - 1, J_, J_)).to(device)
    return (rnd(L, B, J_, 4 * H), cheb, rnd(H, k * 4 * H, scale=H ** -0.5),
            rnd(L, B, J_, H), rnd(L, B, J_, H))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(B, L, J, H, k) for B, L, H, k in
                                   SHAPES.values()]
                         + CUDA_LSTM_WIDE_SHAPES
                         + CUDA_LSTM_WIDE_FORWARD_SHAPES)
def test_cuda_lstm_keep_forward_and_backward_match_plain(cuda_device, shape):
    """The graph-form LSTM kernels: the training forward's outputs and
    residuals against the plain forward with residuals, and (where the
    reverse scan runs) the backward from them against the plain backward,
    with and without the cell states' cotangent, the same bits twice."""
    B, L, _, H, k = shape
    xg, cheb, w, dys, dcs = _lstm_case(shape, cuda_device)
    ys, cs, res = G.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)
    refs = G.graph_lstm_scan_keep_reference(xg, cheb, w)
    for got, want in zip((ys, cs, *res), (*refs[:2], *refs[2])):
        assert float((got - want).abs().max()) <= FWD_ATOL
    if shape in CUDA_LSTM_WIDE_FORWARD_SHAPES:
        return
    for d in (dcs, None):
        got = G.graph_lstm_scan_cuda_bwd(cheb, w, res, cs, dys, d)
        again = G.graph_lstm_scan_cuda_bwd(cheb, w, res, cs, dys, d)
        want = G.graph_lstm_scan_bwd_reference(cheb, w, refs[2], refs[1], dys,
                                               d)
        for g, a, r in zip(got, again, want):
            assert torch.equal(g, a)
            _scaled_close(g.cpu().numpy(), r.cpu().numpy(), "gradient")
