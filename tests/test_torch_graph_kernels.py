"""Port parity for the graph-GRU and graph-LSTM scans, on the CPU: the
port's plain versions against the JAX package's Pallas kernels in interpret
mode (``ops/pallas/fused_graph_gru.py``: ``graph_gru_scan``,
``graph_lstm_scan``), forward and ``jax.vjp``, on the same numpy-seeded
inputs; the Chebyshev matrices; the autograd wrappers' CPU route; the FLOP
and byte counts; the CUDA wrappers refuse CPU tensors; and, on a CUDA card
only, the kernels against their plain versions.

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
    ("lstm", "k3_h3")])
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
    ("lstm", "k3_h3", "all")])
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


def test_stacked_weight_layout_round_trips():
    rng = np.random.default_rng(3)
    H, k = 5, 3
    w = torch.from_numpy(rng.standard_normal((H, k * 2 * H)).astype(
        np.float32))
    stacked = G._stack(w, k)
    assert stacked.shape == (k * H, 2 * H)
    for n in range(k):
        assert torch.equal(stacked[n * H:(n + 1) * H],
                           w[:, n * 2 * H:(n + 1) * 2 * H])
    assert torch.equal(G._unstack(stacked, k), w)
    # [h | T_1 h | ..] W_stacked == sum_n T_n (h W_n)
    h = torch.from_numpy(rng.standard_normal((2, J, H)).astype(np.float32))
    cheb = _cheb(k)
    expanded = torch.cat([h] + [torch.einsum("ij,bjc->bic", t, h)
                                for t in cheb], dim=-1)
    np.testing.assert_allclose(
        (expanded @ stacked).numpy(),
        G._graph_apply(cheb, h @ w, 2 * H).numpy(), atol=1e-5)


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
    assert TF.graph_scan_flops("gru", 256, 16, 26, 128, 2, backward=True) \
        == rows * (3 * 2 * 256 * 384 + 2 * 2 * 2 * 26 * 128)
    assert TF.graph_scan_bytes("gru", 256, 16, 26, 128, 2) \
        == 4 * (rows * 512 + 256 * 384 + 26 * 26)
    # the dense LSTM form: no graph term
    assert TF.graph_scan_flops("lstm", 256, 16, 1, 64, 1) \
        == 256 * 16 * 2 * 64 * 256
    assert TF.graph_scan_bytes("lstm", 4, 2, 1, 8, 1, backward=True,
                               with_dcs=True) \
        == 4 * (8 * (64 + 32) + 2 * 8 * 32)


def test_cuda_wrappers_refuse_cpu_tensors():
    xg, (wzr, wh), (dys,) = _inputs("gru", "k2")
    t = torch.from_numpy
    cheb = _cheb(2)
    with pytest.raises(ValueError, match="CUDA"):
        G.graph_gru_scan_cuda_fwd(t(xg), cheb, t(wzr), t(wh))
    with pytest.raises(ValueError, match="CUDA"):
        G.graph_gru_scan_cuda_bwd(t(xg), cheb, t(wzr), t(wh), t(dys), t(dys))
    lx, (w,), (dy, dc) = _inputs("lstm", "k2")
    with pytest.raises(ValueError, match="CUDA"):
        G.graph_lstm_scan_cuda_fwd(t(lx), cheb, t(w))
    with pytest.raises(ValueError, match="CUDA"):
        G.graph_lstm_scan_cuda_bwd(t(lx), cheb, t(w), t(dy), t(dy), t(dy),
                                   t(dc))
    for fn in (G.graph_gru_scan_cuda_fwd, G.graph_gru_scan_cuda_bwd,
               G.graph_lstm_scan_cuda_fwd, G.graph_lstm_scan_cuda_bwd):
        assert fn.launches == 0


def test_kernel_source_is_packaged_and_keyed():
    assert G._SOURCE.exists() and G._SOURCE.suffix == ".cu"
    path = cuda_build.library_path(G._SOURCE)
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("fused_graph_gru-")
    source = G._SOURCE.read_text()
    assert "atomicAdd" not in source
    for name in G._SIGNATURES:
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
