"""The graph-form LSTM scans' bf16 kernels (rows 12 and 13 in bf16,
``csrc/fused_graph_gru.cu``'s ``lstm_bf16_fwd_kernel`` and
``lstm_bf16_bwd_kernel``) on the CPU:

* where the bf16 entries go, from the source: to the kernels of their own,
  whose products are bf16 ``mma.sync`` m16n8k16 tiles loaded whole by
  ``ldmatrix``, nothing widened; the float32 LSTM, the GRU and the dense
  entries on their own kernels as before;
* the launch plans: the wrapper's copy (``lstm_bf16_plan``) against the
  source's (the entry of a CPU build of the source, ``tools/cpu_standin``)
  over many shapes, and the plans the card takes at GConvLSTM's layer;
* the kernels' logic through the CPU build, at every kind of launch plan
  (the weight resident in one thread block or over a cluster of two,
  streamed; one or two m16 tiles an item), against the bf16 plain
  versions, two calls' bits, a stacked weight's transpose read in place;
* the numerics the graph terms' two bf16 parts buy: the bf16 GConvLSTM
  gradient's distance from the float32 one at most 1.1x the JAX bf16
  kernel's (``jax.vjp`` of the Pallas kernel in interpret mode);
* the autograd route on the card (forced here on CPU tensors): a bf16
  stacked weight's transpose reaches the graph-form entries uncopied.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.ops.pallas import fused_graph_gru as JG

from pedestrians_video_2_carla_torch.ops import cuda_build
from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG
from pedestrians_video_2_carla_torch.skeletons.carla import CARLA_SKELETON

from .torch_threads import limit_torch_threads

limit_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
SOURCE = FG._SOURCE.read_text()
FRAGMENTS = (FG._SOURCE.parent / "bf16_fragments.cuh").read_text()
BF = torch.bfloat16
#: the CPU build's shared memory a thread block and SMs: small enough that
#: small shapes take every kind of plan
STANDIN_SMEM, STANDIN_SMS = 48000, 4
#: the kernels against their plain versions through the CPU build: one
#: bf16 rounding apart at most (the products' fp32 sums in another order)
STANDIN_BAR = 1e-2
#: (B, L, J, H, k) by the plans they take on the CPU build (forward /
#: backward): resident in one block, m16 pairs (J=26, k=2, H=16, B=5: a
#: ragged last block); over a cluster of two, a partial last cluster /
#: streamed; streamed / streamed, odd H; resident, one m16 tile (J=1, k=1);
#: odd H at k=3, resident; over a cluster / streamed, one m16 tile;
#: streamed, one m16 tile
CASES = {"k2_h16": (5, 2, 26, 16, 2), "k2_cluster": (3, 2, 26, 48, 2),
         "k2_streamed_odd_h": (3, 2, 26, 41, 2), "j1_k1": (5, 2, 1, 24, 1),
         "odd_h": (5, 2, 26, 9, 3), "j1_cluster": (5, 2, 1, 48, 3),
         "j1_streamed": (3, 2, 1, 40, 3)}


def _section(text, start, end):
    return text[text.index(start):text.index(end, text.index(start))]


def _function(text, signature):
    """The body of the function whose definition starts with
    ``signature``, to its closing brace at column 0."""
    at = text.index(signature)
    return text[at:text.index("\n}\n", at)]


BF16_LSTM = _section(SOURCE, "// The graph-form LSTM scans in bf16",
                     "// Splits of the rows for the GRU's weight gradients")


def test_bf16_entries_launch_the_bf16_lstm_kernels():
    """The bf16 entries reach lstm_bf16_fwd_kernel and lstm_bf16_bwd_kernel
    (then dW's two launches: lstm_bf16_dw_kernel and the splits' sum), never
    the float32 template's LSTM kernels, which no bf16 instantiation is
    left of."""
    fwd = _function(SOURCE, "int pv2c_graph_lstm_scan_fwd_bf16(")
    assert "lstm_bf16_scan_fwd(" in fwd and "lstm_scan_fwd<" not in fwd
    bwd = _function(SOURCE, "int pv2c_graph_lstm_scan_bwd_bf16(")
    assert "lstm_bf16_scan_bwd(" in bwd and "lstm_scan_bwd<" not in bwd
    launch = _function(SOURCE, "int lstm_bf16_scan_fwd(")
    assert launch.count("lstm_bf16_fwd_kernel<") == 9   # 8 + the decltype
    launch = _function(SOURCE, "int lstm_bf16_scan_bwd(")
    assert launch.count("lstm_bf16_bwd_kernel<") == 5
    assert "lstm_bf16_dw_kernel<true>" in launch
    assert "dw_tf32_kernel" not in launch
    assert "reduce_two_kernel<bf16>" in launch
    assert "cudaLaunchKernelEx(" in _function(SOURCE, "cudaError_t launch_"
                                                      "cluster(")
    for old in ("lstm_scan_fwd<bf16>", "lstm_scan_bwd<bf16>",
                "lstm_scan_fwd_kernel<true, 0, bf16>"):
        assert old not in SOURCE, old


def test_bf16_lstm_products_are_bf16_tensor_core_tiles():
    """Every product of the bf16 LSTM kernels is ``mma_bf16`` (m16n8k16,
    bf16 operands, fp32 sums) on fragments loaded whole by ``ldmatrix``
    from bf16 tiles (dW's sa split into two bf16 tiles as it is staged);
    nothing is widened to float32 and no TF32 pass is taken on them. The
    backward's transposed graph is the float32 template's
    (``graph_product``, TF32 on TF32-rounded P_n)."""
    for fn in ("void fwd_item_product(", "void bwd_item_product(",
               "lstm_bf16_dw_kernel(const float*"):
        body = _function(BF16_LSTM, fn)
        assert "mma_bf16(" in body and "ldsm_x4" in body, fn
        for widen in ("to_f(", "mma_tf32", "split_tf32", "tf32_of_bf16",
                      "bits_to_float", "bf_at("):
            assert widen not in body, (fn, widen)
    fwd = _function(BF16_LSTM, "lstm_bf16_fwd_kernel(const bf16*")
    assert fwd.count("fwd_item_product<MI>(") == 2
    assert "ldsm_x2_t(" in fwd and fwd.count("mma_bf16(") == 1  # the graph
    for tf32 in ("mma_tf32", "mma_3xtf32", "split_tf32", "graph_product<"):
        assert tf32 not in fwd, tf32
    bwd = _function(BF16_LSTM, "lstm_bf16_bwd_kernel(const bf16*")
    assert bwd.count("bwd_item_product<MI>(") == 2
    assert "graph_product<true, true>(" in bwd and "mma_tf32" not in bwd
    for asm in ("ldmatrix.sync.aligned.m8n8.x4.shared.b16",
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16"):
        assert asm in FRAGMENTS, asm
    # the weight is staged in bf16 (16-byte cp.async), once per launch
    # where it stays resident
    for stage in ("void stage_fwd_w(", "void stage_bwd_w("):
        assert "cp_async16(" in _function(BF16_LSTM, stage)
    assert fwd.count("stage_fwd_w(Wsm, w, wt, vec, H, k, Hp, Upp, ldw, 0, "
                     "KW, ubeg, Hq);") == 1
    assert "for (int t = 0; t < L; ++t)" in fwd.split(
        "stage_fwd_w(Wsm, w, wt, vec, H, k, Hp, Upp, ldw, 0, KW")[1]
    # the cluster: rank, barrier, the peer's operand
    assert "cluster_peer(A, q ^ 1)" in fwd and "cluster_sync()" in BF16_LSTM


def test_other_scan_entries_keep_their_kernels():
    """The float32 LSTM (its kernels now float32 alone), both GRU entries
    and the dense entries launch the kernels they launched before."""
    assert "lstm_scan_fwd(" in _function(
        SOURCE, "int pv2c_graph_lstm_scan_fwd(")
    assert "lstm_scan_bwd(" in _function(
        SOURCE, "int pv2c_graph_lstm_scan_bwd(")
    assert "gru_scan_fwd<bf16>(" in _function(
        SOURCE, "int pv2c_graph_gru_scan_fwd_bf16(")
    assert "gru_scan_bwd<bf16>(" in _function(
        SOURCE, "int pv2c_graph_gru_scan_bwd_bf16(")
    assert "gru_scan_fwd<float>(" in _function(
        SOURCE, "int pv2c_graph_gru_scan_fwd(")
    launch = _function(SOURCE, "int lstm_scan_fwd(")
    assert "lstm_scan_fwd_kernel<true, 2>" in launch   # float32 alone
    assert "dw_tf32_kernel<true, float, float>" in _function(
        SOURCE, "int lstm_scan_bwd(")
    dense = FG._DENSE_SOURCE.read_text()
    assert "lstm_bf16" not in dense and "ldsm_" not in dense
    for entry in ("pv2c_dense_lstm_scan_fwd_bf16(", "pv2c_dense_lstm_scan_bwd"
                  "_bf16("):
        assert entry in dense


def test_card_plans_at_gconvlstm_and_k1():
    """On an H100 (132 SMs, 66 clusters of two): GConvLSTM's layer runs
    its forward over clusters of two, 4 clips a cluster, 64 units a block,
    the weight resident (214 KB); its backward 2 clips a block, the weight
    streamed 256 rows a pass; J=1, H=128 both resident, 2 rows a block, one
    m16 tile; ragged B=253 as B=256."""
    card = dict(sms=132, clusters=66)
    assert FG.lstm_bf16_plan(256, 26, 128, 2, False, **card) == \
        (4, 2, 1, 64, 2, 219264, 128)
    assert FG.lstm_bf16_plan(253, 26, 128, 2, False, **card)[:6] == \
        (4, 2, 1, 64, 2, 219264)
    assert FG.lstm_bf16_plan(256, 26, 128, 2, True, **card) == \
        (2, 1, 0, 256, 2, 213120, 128)
    assert FG.lstm_bf16_plan(256, 1, 128, 1, False, **card)[:5] == \
        (2, 1, 1, 128, 1)
    assert FG.lstm_bf16_plan(256, 1, 128, 1, True, **card)[:5] == \
        (2, 1, 1, 128, 1)
    for backward in (False, True):
        assert FG.lstm_bf16_plan(256, 26, 128, 2, backward, **card)[5] \
            <= FG.BF16_LSTM_SMEM


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The graph-scan source built for the CPU (g++, the stand-in
    headers) with a thread block's shared memory cut to STANDIN_SMEM."""
    out = tmp_path_factory.mktemp("standin")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "cpu_standin" / "build.py"),
         "fused_graph_gru.cu", str(out), "--smem-limit", str(STANDIN_SMEM)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return Path(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def standin_wrappers(standin, monkeypatch):
    """The wrappers on the CPU build's entries, taking CPU tensors."""
    lib = ctypes.CDLL(str(standin))
    for name, argtypes in FG._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    monkeypatch.setenv("STANDIN_SMS", str(STANDIN_SMS))
    monkeypatch.setattr(FG, "_library", lambda: lib)
    monkeypatch.setattr(FG, "_stream", lambda device: None)
    monkeypatch.setattr(FG, "_device_index", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda *a, **k: _Null())
    monkeypatch.setattr(cuda_build, "check_cuda_tensors",
                        lambda fn, dtypes=(torch.float32,), **tensors:
                        torch.device("cpu"))
    FG._scan_plan.cache_clear()
    yield lib
    FG._scan_plan.cache_clear()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_plan_mirrors_the_source(standin_wrappers, monkeypatch):
    """lstm_bf16_plan (the wrapper's copy) gives the CPU build's
    pv2c_graph_lstm_bf16_plan numbers over many shapes, both passes; every
    kind of plan turns up."""
    monkeypatch.setattr(FG, "BF16_LSTM_SMEM", STANDIN_SMEM)
    kinds = set()
    for B in (3, 5, 253):
        for J in (1, 26):
            for H in (3, 9, 16, 24, 41, 48, 128):
                for k in (1, 2, 3):
                    for backward in (False, True):
                        plan = torch.zeros(7, dtype=torch.int32)
                        assert standin_wrappers.pv2c_graph_lstm_bf16_plan(
                            B, J, H, k, int(backward), plan.data_ptr()) == 0
                        want = FG.lstm_bf16_plan(B, J, H, k, backward,
                                                 STANDIN_SMS, STANDIN_SMS // 2)
                        assert tuple(plan.tolist()) == want, (B, J, H, k)
                        if want[0]:
                            kinds.add((backward, want[1], want[2], want[4]))
    assert kinds == {(False, 2, 1, 2), (False, 2, 1, 1), (False, 1, 1, 2),
                     (False, 1, 1, 1), (False, 1, 0, 2), (False, 1, 0, 1),
                     (True, 1, 1, 2), (True, 1, 1, 1), (True, 1, 0, 2),
                     (True, 1, 0, 1)}


def _inputs(shape, seed):
    B, L, J, H, k = shape
    rng = np.random.default_rng(seed)
    op = -CARLA_SKELETON.get_adjacency_matrix(
        normalized=True, self_loops=False) if J == 26 else np.zeros((J, J))

    def rnd(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(
            np.float32)).to(BF)
    cheb = torch.from_numpy(FG.cheb_matrices(op, k)).to(BF)
    return (rnd(L, B, J, 4 * H), cheb,
            rnd(H, k * 4 * H, scale=H ** -0.5), rnd(L, B, J, H),
            rnd(L, B, J, H))


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_their_plain_versions(case, standin_wrappers):
    """Through the CPU build at CASES' plans: the training forward's ys,
    cs and residuals, the serving forward's bits, the backward with and
    without dcs against the bf16 plain versions; two calls' bits (the
    second on a stacked weight's transpose, read in place: the same
    bits)."""
    shape = CASES[case]
    B, L, J, H, k = shape
    plans = [FG.graph_lstm_bf16_plan(B, J, H, k, b) for b in (False, True)]
    assert all(p[0] > 0 for p in plans), plans
    xg, cheb, w, dys, dcs = _inputs(shape, sum(shape))
    ys, cs, res = FG.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)
    wt = w.t().contiguous().t()       # a stacked weight's transpose
    assert not wt.is_contiguous()
    again = FG.graph_lstm_scan_cuda_fwd(xg, cheb, wt, keep=True)
    ref = FG.graph_lstm_scan_keep_reference(xg, cheb, w)
    for name, a, b, r in zip(("ys", "cs", "gates", "sa"), (ys, cs, *res),
                             (*again[:2], *again[2]), (*ref[:2], *ref[2])):
        assert a.dtype == r.dtype, name
        assert _rel(a, r) <= STANDIN_BAR, (case, name, _rel(a, r))
        assert torch.equal(a, b), (case, name)
    served = FG.graph_lstm_scan_cuda_fwd(xg, cheb, w)
    assert torch.equal(served[0], ys) and torch.equal(served[1], cs)
    # with dcs twice, then the transpose's (its bits), then without dcs
    got = FG.graph_lstm_scan_cuda_bwd(cheb, w, res, cs, dys, dcs)
    for again, cot in ((FG.graph_lstm_scan_cuda_bwd(cheb, w, res, cs, dys,
                                                    dcs), dcs),
                       (FG.graph_lstm_scan_cuda_bwd(cheb, wt, res, cs, dys,
                                                    dcs), dcs)):
        assert all(map(torch.equal, got, again)), case
    for cot in (dcs, None):
        if cot is None:
            got = FG.graph_lstm_scan_cuda_bwd(cheb, w, res, cs, dys, None)
        want = FG.graph_lstm_scan_bwd_reference(cheb, w, res, cs, dys, cot)
        for name, a, r in zip(("dxg", "dw"), got, want):
            assert a.dtype == BF and a.shape == r.shape, name
            assert _rel(a, r) <= STANDIN_BAR, (case, name, _rel(a, r))


def test_graph_terms_two_bf16_parts_in_the_plain_version():
    """The bf16 plain forward takes each graph term as hi + lo (two bf16
    values: 16 significant bits) and keeps it in sa rounded to TF32; the
    GRU's stay TF32; float32 is unchanged."""
    xg, cheb, w, _, _ = _inputs((3, 2, 26, 8, 2), 5)
    ys, cs, res = FG.graph_lstm_scan_keep_reference(xg, cheb, w)
    H, k = 8, 2
    h = ys[0].float()                     # frame 1's operand: h of frame 0
    th = torch.einsum("ij,bjc->bic", cheb[0].float(), h)
    hi = th.to(BF).float()
    lo = (th - hi).to(BF).float()
    sa1 = res.sa.reshape(2, 3, 26, H, k)[1]
    assert torch.equal(sa1[..., 0], h)
    bits = (hi + lo).contiguous().view(torch.int32)
    assert torch.equal(sa1[..., 1], ((bits + 0x1000) & ~0x1fff).view(
        torch.float32))
    assert not torch.equal(hi + lo, hi)   # lo carries bits bf16 drops
    x32 = xg.float()
    assert torch.allclose(FG.graph_lstm_scan_keep_reference(
        x32, cheb.float(), w.float())[0], FG.graph_lstm_scan_reference(
        x32, cheb.float(), w.float())[0], atol=1e-6)


def _grads_port(xg, cheb, w, dys, dcs):
    leaves = [t.detach().clone().requires_grad_(True) for t in (xg, w)]
    outs = FG.graph_lstm_scan(leaves[0], cheb, leaves[1], with_c=True)
    return [g.float().numpy() for g in torch.autograd.grad(
        outs, leaves, (dys, dcs))]


def test_bf16_gradient_is_no_further_from_fp32_than_the_jax_kernels():
    """On seeded bf16 inputs at GConvLSTM's width ratio (J=26, k=2, L=16),
    the port's bf16 gradient (dxg and dW, autograd of the plain version:
    the kernels' rounding) lies at most 1.1x as far from the float32 one
    as the JAX bf16 kernel's (``jax.vjp``, interpret mode)."""
    B, L, J, H, k = 6, 16, 26, 16, 2
    xg, cheb, w, dys, dcs = _inputs((B, L, J, H, k), 28)
    fp32 = _grads_port(xg.float(), cheb.float(), w.float(), dys.float(),
                       dcs.float())
    port = _grads_port(xg, cheb, w, dys, dcs)
    op = -CARLA_SKELETON.get_adjacency_matrix(normalized=True,
                                              self_loops=False)
    a_ops = jnp.asarray(JG.kron_cheb_ops(op, k), jnp.bfloat16)
    R = J * JG.BBR

    def to_port(y):
        return jnp.swapaxes(JG.from_slabs(y, B, J), 0, 1)

    def run(x, w_):
        xs, _ = JG.to_slabs(jnp.swapaxes(x, 0, 1))
        bg = JG.pick_block_groups(xs.shape[1] // R)
        ys, cs = JG.graph_lstm_scan(xs, a_ops, w_, k, R, bg, True)
        return to_port(ys), to_port(cs)

    def vjp(x, w_, cts):
        return jax.vjp(run, x, w_)[1](cts)

    def bf(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    jgrads = jax.jit(vjp)(bf(xg), bf(w), (bf(dys), bf(dcs)))
    jax_grads = [np.asarray(g, np.float32) for g in jgrads]

    def distance(grads):
        got = np.concatenate([g.ravel() for g in grads])
        want = np.concatenate([g.ravel() for g in fp32])
        return np.linalg.norm(got - want) / np.linalg.norm(want)
    assert np.isfinite(distance(port))
    assert distance(port) <= 1.1 * distance(jax_grads), (
        distance(port), distance(jax_grads))


def test_stacked_bf16_weight_reaches_the_graph_entries_uncopied(monkeypatch):
    """On the card (forced here on CPU tensors, the CUDA entries swapped
    for their plain versions) a bf16 graph-form scan takes the transpose of
    a contiguous (k 4H, H) weight as it is, forward and backward; float32
    still copies it to the layout its kernels read."""
    seen = []

    def fwd(xg, cheb, w, keep=False):
        seen.append(("fwd", xg.dtype, w.is_contiguous()))
        ys, cs, res = FG.graph_lstm_scan_keep_reference(xg, cheb, w)
        return (ys, cs, res) if keep else (ys, cs)

    def bwd(cheb, w, res, cs, dys, dcs=None):
        seen.append(("bwd", dys.dtype, w.is_contiguous()))
        return FG.graph_lstm_scan_bwd_reference(cheb, w, res, cs, dys, dcs)
    monkeypatch.setattr(FG, "_check_device", lambda name, t: True)
    monkeypatch.setattr(FG, "dense_lstm_plan", lambda *a, **k: (0,) * 6)
    monkeypatch.setattr(FG, "graph_lstm_scan_cuda_fwd", fwd)
    monkeypatch.setattr(FG, "graph_lstm_scan_cuda_bwd", bwd)
    monkeypatch.setattr(FG, "graph_lstm_scan_fwd_op", fwd)
    xg, cheb, w, dys, _ = _inputs((3, 2, 26, 8, 2), 7)
    for dtype in (BF, torch.float32):
        seen.clear()
        x = xg.to(dtype).requires_grad_(True)
        stacked = w.t().contiguous().to(dtype).requires_grad_(True)
        ys = FG.graph_lstm_scan(x, cheb.to(dtype), stacked.t())
        dx, dw = torch.autograd.grad(ys, (x, stacked), dys.to(dtype))
        assert seen == [("fwd", dtype, dtype != BF), ("bwd", dtype,
                                                      dtype != BF)]
        assert dw.shape == stacked.shape and dx.shape == x.shape
