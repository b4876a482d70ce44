"""The spatial stack's bf16 kernels (rows 4 and 5 in bf16,
``csrc/fused_spatial_transformer.cu``) on the CPU:

* where their products go, from the source: the forward's on bf16
  ``mma.sync`` m16n8k16 tiles with no TF32 pass on bf16 tiles; the
  backward's on TF32 ``mma.sync`` tiles, 3xTF32 for the weight gradients
  and two passes for the activation gradients, none with a bf16 operand;
  the float32 entries on their own kernels;
* their shared-memory plans: the wrapper's copies against the source's
  layouts (the entries of a CPU build of the source, ``tools/cpu_standin``)
  and the tiles they give, within an SM, at every shape the float32
  kernels take;
* the backward's product split (``dx_product_tf32x2``,
  ``dw_product_tf32x3`` in ``spatial_stack_bwd_reference``) against the
  JAX kernel's float32 backward (``jax.vjp`` of ``fused_spatial_stack``,
  its Pallas kernels in interpret mode) on bf16-valued weights, within
  1e-4 of each gradient's largest (the float32 backward's bar), which the
  same products on bf16 operands miss;
* the kernels' logic through the CPU build: the bf16 forward, its
  residuals and the backward from them against the plain versions (the
  backward within 2^-8 of max |plain| of its plain algorithm in float32:
  one bf16 rounding), two calls' bits.
"""
import functools
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.ops.pallas import \
    fused_spatial_transformer as JS

from pedestrians_video_2_carla_torch.ops import cuda_build
from pedestrians_video_2_carla_torch.ops import fused_spatial_transformer as FS
from pedestrians_video_2_carla_torch.ops.tensors import round_bf16

from .test_torch_transformer_kernels import _block_weights, _to_port
from .torch_threads import limit_torch_threads

limit_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
SOURCE = FS._SOURCE.read_text()
HEADER = (FS._SOURCE.parent / "mma_tf32.cuh").read_text()
#: the float32 backward's bar (rtol 1e-4 of each gradient's largest), and
#: one bf16 rounding of fp32-accurate results
FP32_BAR, BF16_BWD_BAR = 1e-4, 2.0 ** -8
#: (J, E, heads, hidden): PoseFormer's, chip_smoke.py's SPATIAL_WIDE and
#: SPATIAL_EDGE shapes
SHAPES = ((26, 32, 8, 64), (26, 32, 1, 64), (26, 64, 8, 128),
          (26, 20, 5, 40), (32, 12, 3, 864), (32, 12, 1, 860))


def _section(text, start, end):
    return text[text.index(start):text.index(end, text.index(start))]


def _function(text, signature):
    """The body of the function whose definition starts with
    ``signature``, to its closing brace at column 0."""
    at = text.index(signature)
    return text[at:text.index("\n}\n", at)]


FWD_BF16 = _section(SOURCE, "// Forward, bf16", "// Backward: dx and")
BWD_BF16 = _section(SOURCE, "// Backward, bf16", "bool valid(")


def test_bf16_forward_products_are_bf16_tensor_core_tiles():
    """The bf16 entry launches its own kernel, whose four products are
    ``mma_bf16`` (m16n8k16, bf16 operands, fp32 sums) on bf16 tiles in
    shared memory; no TF32 pass and no widening to float32 is left on
    them."""
    entry = _function(SOURCE, "int pv2c_fused_spatial_stack_bf16(")
    assert "launch_fwd_bf16(" in entry and "launch_fwd(" not in entry
    launch = _function(SOURCE, "int launch_fwd_bf16(")
    assert "spatial_stack_bf16_kernel<4>" in launch
    assert "spatial_stack_bf16_kernel<0>" in launch
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in HEADER
    product = _function(FWD_BF16, "__device__ void product_bf16(")
    assert "mma_bf16(" in product
    for tf32 in ("mma_tf32", "mma_3xtf32", "tf32_of_bf16", "split_tf32"):
        assert tf32 not in FWD_BF16, tf32
    block = _function(FWD_BF16, "__device__ void block_fwd_bf16(")
    assert block.count("warp_product_bf16<") == 4
    # the weights are copied as bf16 (cp.async), not widened
    assert "cp_async8(" in _function(FWD_BF16, "__device__ void stage_bf(")
    # the float32 entry keeps its kernel
    assert "launch_fwd(" in _function(SOURCE, "int pv2c_fused_spatial_stack(")


def test_bf16_backward_products_are_fp32_accurate_tensor_core_tiles():
    """The bf16 backward's eight products a depth block run on the
    tensor-core tasks: the dW products in 3xTF32 (``mma_3xtf32`` on split
    operands), the dX products as two TF32 passes on the split activation
    and the bf16 weight, exact in TF32; no bf16-operand product and no
    CUDA-core product is left in the bf16 backward."""
    entry = _function(SOURCE, "int pv2c_fused_spatial_stack_bwd_bf16(")
    assert "launch_bwd_bf16(" in entry and "launch_bwd(" not in entry
    launch = _function(SOURCE, "int launch_bwd_bf16(")
    assert "spatial_mlp_bwd_tc_kernel<<<" in launch
    assert "attn<<<" in launch and "spatial_attn_bwd_tc_kernel<4>" in SOURCE
    assert "mma_bf16" not in BWD_BF16 and "tf32_of_bf16" not in BWD_BF16
    dw = _function(BWD_BF16, "__device__ void tc_dw_task(")
    assert dw.count("split_tf32(") == 6
    for passes in ("(e[j], as, bb)", "(f[j], ab, bsm)", "(d[j], ab, bb)"):
        assert "mma_tf32" + passes in dw, passes
    dx = _function(BWD_BF16, "__device__ void tc_dx_task(")
    assert dx.count("split_tf32(") == 4
    for passes in ("(e[j], as, bb)", "(acc[j], ab, bb)"):
        assert "mma_tf32" + passes in dx, passes
    for kernel in ("spatial_mlp_bwd_tc_kernel(", "spatial_attn_bwd_tc_kernel("):
        body = _function(BWD_BF16, kernel.join(("__global__ void __launch_b"
                                                "ounds__(kThreads, 2)\n    ",
                                                "")))
        assert body.count("tc_phase<") == 2, kernel
        assert "dense<" not in body and "dense_dw<" not in body, kernel
    # the float32 entry keeps its kernels
    assert "launch_bwd(" in _function(SOURCE,
                                      "int pv2c_fused_spatial_stack_bwd(")


@functools.lru_cache(maxsize=None)
def _cpu_build(out: str):
    """The source built for the CPU (tools/cpu_standin/build.py) -> the
    library's path."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "cpu_standin" / "build.py"),
         FS._SOURCE.name, out], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def cpu_library(tmp_path_factory):
    import ctypes
    lib = ctypes.CDLL(_cpu_build(str(tmp_path_factory.mktemp("standin"))))
    for name, argtypes in FS._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_plans_mirror_the_source(cpu_library, shape):
    """The wrapper's copies of the bf16 kernels' shared-memory layouts
    give the source's bytes (its entries in a CPU build) at the tiles the
    wrapper picks and at every tile it tries."""
    J, E, heads, hidden = shape
    for frames in FS.FORWARD_TILES_BF16:
        assert cpu_library.pv2c_spatial_stack_bf16_smem_bytes(
            J, E, heads, hidden, frames) == FS.bf16_forward_smem_bytes(
            J, E, hidden, frames)
    for rows in FS.ROW_TILES_BF16:
        assert cpu_library.pv2c_spatial_mlp_bwd_bf16_smem_bytes(
            E, hidden, rows) == FS.mlp_bwd_bf16_smem_bytes(E, hidden, rows)
    for frames in FS.FRAME_TILES:
        assert cpu_library.pv2c_spatial_attn_bwd_bf16_smem_bytes(
            J, E, heads, frames) == FS.attn_bwd_bf16_smem_bytes(
            J, E, heads, frames)
    # and the float32 layouts are the float32 kernels' still
    fwd, rows, frames = FS.kernel_tiles(J, E, heads, hidden)
    assert cpu_library.pv2c_spatial_mlp_bwd_smem_bytes(E, hidden, rows) == \
        FS.mlp_bwd_smem_bytes(E, hidden, rows)


def test_bf16_tiles_fit_and_take_every_float32_shape():
    """PoseFormer's bf16 tiles: 5 frames a forward thread block, 112 rows
    of the backward's MLP half and 2 frames of its attention half, each
    with room for a second thread block on the SM; every shape the float32
    kernels take (J <= 32, E <= 128, head width <= 32, hidden up to 8 E)
    the bf16 kernels take, within one thread block's shared memory."""
    tiles = FS.kernel_tiles(26, 32, 8, 64, element_size=2)
    assert tiles == (5, 112, 2)
    sizes = (FS.bf16_forward_smem_bytes(26, 32, 64, 5),
             FS.mlp_bwd_bf16_smem_bytes(32, 64, 112),
             FS.attn_bwd_bf16_smem_bytes(26, 32, 8, 2))
    assert all(s <= FS.TWO_PER_SM_BYTES for s in sizes)
    # one step more does not fit two an SM: the picks are the largest
    assert FS.bf16_forward_smem_bytes(26, 32, 64, 6) > FS.TWO_PER_SM_BYTES
    assert max(FS.FORWARD_TILES_BF16) == 5  # the registers of two an SM
    assert FS.mlp_bwd_bf16_smem_bytes(32, 64, 128) > FS.TWO_PER_SM_BYTES
    assert FS.attn_bwd_bf16_smem_bytes(26, 32, 8, 3) > FS.TWO_PER_SM_BYTES
    taken = 0
    for J in (1, 9, 26, 32):
        for E in range(4, 129, 12):
            for heads in {h for h in (1, 2, 4, 8) if E % h == 0}:
                for hidden in (4, E, 2 * E, 4 * E, 8 * E, 860, 864):
                    try:
                        FS.kernel_tiles(J, E, heads, hidden)
                    except ValueError:
                        continue
                    fwd, rows, frames = FS.kernel_tiles(J, E, heads, hidden,
                                                        element_size=2)
                    assert rows % 16 == 0
                    assert max(FS.bf16_forward_smem_bytes(J, E, hidden, fwd),
                               FS.mlp_bwd_bf16_smem_bytes(E, hidden, rows),
                               FS.attn_bwd_bf16_smem_bytes(J, E, heads,
                                                           frames)) \
                        <= FS.MAX_SMEM_BYTES
                    taken += 1
    assert taken > 100


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / max(float(np.abs(np.asarray(ref)).max()), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_fp32_backward():
    """Seeded float32 x and cotangent, bf16-valued float32 weights (the
    values the bf16 entry takes), and the JAX kernel's float32 backward on
    them (``jax.vjp`` of ``fused_spatial_stack``, Pallas in interpret
    mode), the weight gradients in the port's layouts."""
    J, E, heads, depth, N = 26, 8, 4, 2, 13
    rng = np.random.default_rng(2731)
    x = rng.standard_normal((N, J, E)).astype(np.float32)
    g = rng.standard_normal((N, J, E)).astype(np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
        jnp.float32))
    blocks = [bf(w) for w in _block_weights(rng, E, lead=(depth,))]
    lnf = [bf(1 + 0.2 * rng.standard_normal(E).astype(np.float32)),
           bf(0.2 * rng.standard_normal(E).astype(np.float32))]
    jw = tuple(jnp.asarray(w) for w in blocks) + (
        jnp.asarray(lnf[0])[None], jnp.asarray(lnf[1])[None])

    def fwd_vjp(x, w, g):
        out, vjp = jax.vjp(lambda x, w: JS.fused_spatial_stack(x, w, heads),
                           x, w)
        return vjp(g)
    dx, dws = jax.device_get(jax.jit(fwd_vjp)(jnp.asarray(x), jw,
                                              jnp.asarray(g)))
    ref = [np.asarray(dx)] + [
        np.swapaxes(d, -1, -2) if i in (2, 4, 8, 10) else np.asarray(d)
        for i, d in enumerate(dws[:12])] + [np.asarray(dws[12][0]),
                                             np.asarray(dws[13][0])]
    weights = _to_port(blocks) + [torch.from_numpy(a) for a in lnf]
    return torch.from_numpy(x), weights, torch.from_numpy(g), heads, ref


def _model_backward(dx_product, dw_product):
    x, weights, g, heads, ref = _jax_fp32_backward()
    _, saved = FS.spatial_stack_keep_reference(x, weights, heads)
    dx, dws = FS.spatial_stack_bwd_reference(x, weights, saved, g, heads,
                                             dx_product, dw_product)
    return [_rel(a.numpy(), r) for a, r in zip((dx, *dws), ref)]


def test_bf16_backward_split_meets_the_fp32_bars_against_jax():
    """The bf16 backward's tensor-core passes, modelled in plain PyTorch
    on ``round_tf32`` (the dW products' operands split into big and small
    TF32 parts, three products; the dX products' activation split, the
    bf16 weight whole, two), give the JAX kernel's float32 backward within
    1e-4 of each gradient's largest, as the plain float32 algorithm does;
    the dW products on bf16 operands, or one TF32 pass, would not."""
    split = _model_backward(FS.dx_product_tf32x2, FS.dw_product_tf32x3)
    assert max(split) <= FP32_BAR, split
    plain = _model_backward(torch.matmul, lambda dy, a: dy.t() @ a)
    assert max(plain) <= FP32_BAR, plain
    on_bf16 = _model_backward(
        FS.dx_product_tf32x2,
        lambda dy, a: round_bf16(dy).t() @ round_bf16(a))
    assert max(on_bf16) > 10 * FP32_BAR, on_bf16

    def one_pass(dy, a):
        big = lambda t: FS._split_tf32(t)[0]
        return big(dy).t() @ big(a)
    assert max(_model_backward(FS.dx_product_tf32x2, one_pass)) > FP32_BAR


@pytest.fixture
def cpu_kernels(cpu_library, monkeypatch):
    """The wrapper pointed at the CPU build, taking CPU tensors."""
    import contextlib
    import types
    monkeypatch.setattr(FS, "_library", lambda: cpu_library)
    monkeypatch.setattr(cuda_build, "check_cuda_tensors",
                        lambda *a, **k: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: types.SimpleNamespace(
                            cuda_stream=None))


@pytest.mark.parametrize("shape", [(5, 26, 32, 8, 64, 1),
                                   (3, 32, 12, 3, 864, 1)])
def test_bf16_kernels_logic_on_a_cpu_build(cpu_kernels, shape):
    """The bf16 forward (serving and ``keep``), its kept residuals and the
    backward from them, through a CPU build of the source (a thread block
    as threads, ``mma.sync`` exchanged within a warp) at PoseFormer's
    widths and at an edge shape: the output within the bf16 bar of the
    plain version, the residuals the plain training forward's, the
    gradients within 2^-8 of the backward's plain algorithm in float32 from
    the same residuals, the same bits twice."""
    N, J, E, heads, hidden, depth = shape
    rng = np.random.default_rng(2732)
    blocks = _block_weights(rng, E, lead=(depth,), hidden=hidden)
    lnf = [1 + 0.2 * rng.standard_normal(E).astype(np.float32),
           0.2 * rng.standard_normal(E).astype(np.float32)]
    ws = [t.to(torch.bfloat16) for t in _to_port(blocks)] + [
        torch.from_numpy(a).to(torch.bfloat16) for a in lnf]
    x, g = (torch.from_numpy(rng.standard_normal((N, J, E)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    out = FS.fused_spatial_stack_cuda(x, ws, heads)
    kept, saved = FS.fused_spatial_stack_cuda(x, ws, heads, keep=True)
    ref, ref_saved = FS.spatial_stack_keep_reference(x, ws, heads)
    assert out.dtype == torch.bfloat16 and torch.equal(out, kept)
    assert _rel(out.float(), ref.float()) <= 2e-2
    for name, a, b in zip(FS.SAVED, saved, ref_saved):
        assert _rel(a, b) <= 1e-3, name
    dx, dws = FS.fused_spatial_stack_cuda_bwd(x, ws, saved, g, heads)
    again = FS.fused_spatial_stack_cuda_bwd(x, ws, saved, g, heads)
    exact = FS.spatial_stack_bwd_reference(x, ws, saved, g, heads)
    for got, twice, want in zip((dx, *dws), (again[0], *again[1]),
                                (exact[0], *exact[1])):
        assert got.dtype == torch.bfloat16 and torch.equal(got, twice)
        assert _rel(got.float(), want) <= BF16_BWD_BAR


def test_phase_split_instruments_both_forwards():
    """chip_smoke.py's phase split finds each forward of the source: the
    float32 kernel (the warp design) and the bf16 kernel (the same phases:
    seven warp barriers a depth block, the load's and the final
    LayerNorm's, two thread-block barriers around the staging)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    for bf16 in (False, True):
        text, design = chip_smoke.instrument_spatial_forward(SOURCE, bf16)
        assert design == "warp"
        name = "block_fwd_bf16(" if bf16 else "block_fwd("
        block = _function(text, "__device__ void " + name)
        assert block.count("__syncwarp(); split_stamp();") == 7
        assert len(chip_smoke.SPLIT_PHASES[design][False]) == 9
    kernel = _function(text, "    spatial_stack_bf16_kernel(")
    assert kernel.count("split_stamp();") == 6
