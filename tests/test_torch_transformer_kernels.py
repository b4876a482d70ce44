"""Port parity for PoseFormer's transformer kernels: the spatial stack and
the temporal block (and stack), plain versions and the fused routes (which
run the plain versions for CPU tensors), against the JAX package's Pallas
kernels (interpret mode on the CPU, as tests/ops/test_pallas_spatial.py and
test_pallas_temporal.py run them) and their XLA references, at atol 1e-5
(the JAX kernel tests' forward bar); the FLOP formulas against the JAX
package's; input checks; and, on a CUDA card only, the kernels against
their plain versions. The backward's parity is in
``test_torch_pose_former_training.py``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.ops.pallas import flops as JF
from pedestrians_video_2_carla_tpu.ops.pallas import \
    fused_spatial_transformer as JS
from pedestrians_video_2_carla_tpu.ops.pallas import \
    fused_temporal_transformer as JT

from pedestrians_video_2_carla_torch.ops import flops as TF
from pedestrians_video_2_carla_torch.ops import fused_spatial_transformer as FS
from pedestrians_video_2_carla_torch.ops import \
    fused_temporal_transformer as FT
from pedestrians_video_2_carla_torch.ops import cuda_build
from .torch_threads import limit_torch_threads

limit_torch_threads()

ATOL = 1e-5
J, E, H_S, DEPTH = 26, 8, 4, 2        # spatial: head width 2
N_S = 13                              # ragged: not a multiple of 8
T, D, H_T, N_T = 3, 208, 4, 7         # temporal: frame_dim 26 x 8
KERNEL_BAR = 1e-5                     # max |kernel - plain| / max |plain|


def _block_weights(rng, dim, lead=(), hidden=None):
    """One block's weights in the JAX layout (Dense kernels (in, out)),
    hidden 2 dim unless given, with LayerNorm scales and biases away from
    ones and zeros."""
    hidden = 2 * dim if hidden is None else hidden

    def w(*shape, scale):
        return (rng.standard_normal(lead + shape) * scale).astype(np.float32)
    k = dim ** -0.5
    return [1 + w(dim, scale=0.2), w(dim, scale=0.2),
            w(dim, 3 * dim, scale=k), w(3 * dim, scale=0.1),
            w(dim, dim, scale=k), w(dim, scale=0.1),
            1 + w(dim, scale=0.2), w(dim, scale=0.2),
            w(dim, hidden, scale=k), w(hidden, scale=0.1),
            w(hidden, dim, scale=hidden ** -0.5), w(dim, scale=0.1)]


def _to_port(weights):
    """JAX weights -> the port's: Dense kernels transposed to nn.Linear
    layout (the last two axes of the 2-D and stacked 3-D kernels)."""
    kernels = {2, 4, 8, 10}
    return [torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(w, -1, -2) if i in kernels else w))
        for i, w in enumerate(weights)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _spatial_case():
    rng = np.random.default_rng(22742)
    x = rng.standard_normal((N_S, J, E)).astype(np.float32)
    blocks = _block_weights(rng, E, lead=(DEPTH,))
    lnf = [1 + 0.2 * rng.standard_normal(E).astype(np.float32),
           0.2 * rng.standard_normal(E).astype(np.float32)]
    jw = tuple(jnp.asarray(w) for w in blocks) + (
        jnp.asarray(lnf[0])[None], jnp.asarray(lnf[1])[None])
    pallas = np.asarray(JS.fused_spatial_stack(jnp.asarray(x), jw, H_S))
    ref = np.asarray(JS.spatial_stack_reference(jnp.asarray(x), jw, H_S))
    return x, _to_port(blocks) + [_t(lnf[0]), _t(lnf[1])], pallas, ref


@pytest.mark.parametrize("port_fn", [FS.spatial_stack_reference,
                                     FS.fused_spatial_stack],
                         ids=["plain", "fused_route"])
def test_spatial_stack_matches_jax(port_fn):
    x, weights, pallas, ref = _spatial_case()
    out = port_fn(_t(x), weights, H_S).numpy()
    assert out.shape == (N_S, J, E)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _temporal_case():
    rng = np.random.default_rng(22743)
    x = rng.standard_normal((N_T, T, D)).astype(np.float32)
    blocks = [_block_weights(rng, D) for _ in range(2)]
    jw = [tuple(jnp.asarray(w) for w in b) for b in blocks]
    block = np.asarray(JT.fused_temporal_block(jnp.asarray(x), jw[0], H_T))
    ref = np.asarray(JT.temporal_block_reference(jnp.asarray(x), jw[0], H_T))
    stack = np.asarray(JT.fused_temporal_stack(jnp.asarray(x), jw, H_T))
    return x, [_to_port(b) for b in blocks], block, ref, stack


@pytest.mark.parametrize("port_fn", [FT.temporal_block_reference,
                                     FT.fused_temporal_block],
                         ids=["plain", "fused_route"])
def test_temporal_block_matches_jax(port_fn):
    x, weights, block, ref, _ = _temporal_case()
    out = port_fn(_t(x), weights[0], H_T).numpy()
    assert out.shape == (N_T, T, D)
    np.testing.assert_allclose(out, block, rtol=0, atol=ATOL)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_temporal_stack_matches_jax():
    x, weights, _, _, stack = _temporal_case()
    out = FT.fused_temporal_stack(_t(x), weights, H_T).numpy()
    np.testing.assert_allclose(out, stack, rtol=0, atol=ATOL)


def test_temporal_keep_reference_is_the_forward_with_its_scratch():
    """The plain training forward (the CUDA forward's ``keep`` scratch in
    its layout) gives the JAX kernel's output, and its scratch holds what
    row 9's backward reads: the LayerNorm statistics, qkv, the attention
    output before proj, x2, h and GELU(h)."""
    x, weights, block, _, _ = _temporal_case()
    (ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
     ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b) = weights[0]
    out, saved = FT.temporal_block_keep_reference(_t(x), weights[0], H_T)
    np.testing.assert_allclose(out.numpy(), block, rtol=0, atol=ATOL)
    stats, qkv, attn, x2, h, mlp = saved
    M = N_T * T
    assert [tuple(t.shape) for t in saved] == [
        (4 * M,), (M, 3 * D), (M, D), (M, D), (M, 2 * D), (M, 2 * D)]
    rows = _t(x).reshape(M, D)
    mu1, inv1, mu2, inv2 = stats.reshape(4, M, 1)
    close = functools.partial(torch.testing.assert_close, rtol=0, atol=ATOL)
    close(mu1, rows.mean(-1, keepdim=True))
    close(mu2, x2.mean(-1, keepdim=True))
    close(inv2, torch.rsqrt(x2.var(-1, unbiased=False, keepdim=True)
                            + 1e-5))
    close(qkv, ((rows - mu1) * inv1 * ln1_s + ln1_b) @ qkv_w.T + qkv_b)
    close(x2, rows + attn @ proj_w.T + proj_b)
    close(h, ((x2 - mu2) * inv2 * ln2_s + ln2_b) @ fc1_w.T + fc1_b)
    close(mlp, torch.nn.functional.gelu(h))
    close(out.reshape(M, D), x2 + mlp @ fc2_w.T + fc2_b)


def test_forward_gemm_plan_mirrors_the_source():
    """The wrapper's copy of the forward GEMM's plan is the source's, and
    two of its thread blocks fit an SM's shared memory."""
    import re
    src = FT._SOURCE.read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))
    plan = FT.FORWARD_GEMM
    assert plan["block"] == (const("kFBM"), const("kFBN"))
    assert plan["warp"] == (const("kFWM"), const("kFWN"))
    assert (plan["k_step"], plan["stages"], plan["blocks_per_sm"]) == (
        const("kFBK"), const("kFStages"), const("kFMinBlocks"))
    assert set(plan) == {"block", "warp", "k_step", "stages",
                         "blocks_per_sm"}
    smem = FT.forward_gemm_smem_bytes()
    assert smem == 4 * 3 * 256 * 36 == 110592
    assert plan["blocks_per_sm"] * (smem + FT.BLOCK_RESERVED_BYTES) \
        <= FT.SM_SMEM_BYTES
    # a third thread block would not fit: the launch bounds ask for two
    assert (plan["blocks_per_sm"] + 1) * (smem + FT.BLOCK_RESERVED_BYTES) \
        > FT.SM_SMEM_BYTES


@pytest.mark.parametrize("shape", [
    dict(n_tokens=106496, dim=32, seq_len=26),
    dict(n_tokens=18432, dim=832, seq_len=9),
    dict(n_tokens=100, dim=208, mlp_ratio=3.0),
])
def test_flops_match_jax(shape):
    assert TF.transformer_block_matmul_flops(**shape) == \
        JF.transformer_block_matmul_flops(**shape)


def test_flops_at_the_serving_shape():
    # B=256, L=16: 4 spatial blocks of 106,496 tokens, and one temporal
    # block of 2048 windows x 9 tokens
    assert 4 * TF.transformer_block_matmul_flops(106496, 32, seq_len=26) \
        == 8_396_996_608
    assert TF.transformer_block_matmul_flops(18432, 832, seq_len=9) \
        == 204_697_239_552


def test_kernel_wrappers_never_run_on_the_cpu():
    x, weights, _, _ = _spatial_case()
    with pytest.raises(ValueError, match="CUDA"):
        FS.fused_spatial_stack_cuda(_t(x), weights, H_S)
    xt, wt, _, _, _ = _temporal_case()
    with pytest.raises(ValueError, match="CUDA"):
        FT.fused_temporal_block_cuda(_t(xt), wt[0], H_T)
    assert FS.fused_spatial_stack_cuda.launches == 0
    assert FT.fused_temporal_block_cuda.launches == 0


def test_wrappers_check_their_inputs():
    x, weights, _, _ = _spatial_case()
    with pytest.raises(ValueError):
        FS.fused_spatial_stack(_t(x), weights[:13], H_S)
    with pytest.raises(ValueError):
        FS.fused_spatial_stack(_t(x), weights, 3)          # 3 does not divide 8
    with pytest.raises(TypeError):
        FS.fused_spatial_stack(_t(x).double(), weights, H_S)
    xt, wt, _, _, _ = _temporal_case()
    with pytest.raises(ValueError):
        FT.fused_temporal_block(_t(xt)[..., :-1], wt[0], H_T)
    bad = list(wt[0])
    bad[2] = bad[2][:, :-1]
    with pytest.raises(ValueError, match="qkv_w"):
        FT.fused_temporal_block(_t(xt), bad, H_T)


def test_each_kernel_has_its_own_library():
    spatial = cuda_build.library_path(FS._SOURCE)
    temporal = cuda_build.library_path(FT._SOURCE)
    assert spatial.name.startswith("fused_spatial_transformer-")
    assert temporal.name.startswith("fused_temporal_transformer-")
    assert spatial.parent == temporal.parent == cuda_build.BUILD_DIR


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # the plain versions' GEMMs in full float32, as the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scaled_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4093, 5])
def test_cuda_spatial_matches_plain(rng, cuda_device, n):
    x = torch.from_numpy(rng.standard_normal((n, 26, 32)).astype(
        np.float32)).to(cuda_device)
    blocks = _to_port(_block_weights(rng, 32, lead=(4,)))
    weights = [w.to(cuda_device) for w in blocks] + [
        torch.ones(32, device=cuda_device), torch.zeros(32, device=cuda_device)]
    out = FS.fused_spatial_stack_cuda(x, weights, 8)
    ref = FS.spatial_stack_reference(x, weights, 8)
    torch.cuda.synchronize()
    assert _scaled_err(out, ref) <= KERNEL_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("emb,heads", [(20, 5), (32, 1), (64, 8)])
def test_cuda_spatial_wide_shapes_match_plain(rng, cuda_device, emb, heads):
    # widths 4 mod 8 (the products' zero-padded k-edge), head width 32, and
    # fewer frames a thread block; hidden 2 emb; the training forward too
    x = torch.from_numpy(rng.standard_normal((1021, 26, emb)).astype(
        np.float32)).to(cuda_device)
    blocks = _to_port(_block_weights(rng, emb, lead=(4,)))
    weights = [w.to(cuda_device) for w in blocks] + [
        torch.ones(emb, device=cuda_device),
        torch.zeros(emb, device=cuda_device)]
    out = FS.fused_spatial_stack_cuda(x, weights, heads)
    kept, _ = FS.fused_spatial_stack_cuda(x, weights, heads, keep=True)
    ref = FS.spatial_stack_reference(x, weights, heads)
    torch.cuda.synchronize()
    assert _scaled_err(out, ref) <= KERNEL_BAR
    assert torch.equal(out, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("J,emb,heads,hidden",
                         [(32, 12, 3, 864), (32, 12, 1, 860)])
def test_cuda_spatial_edge_shapes_match_plain(rng, cuda_device, J, emb, heads,
                                              hidden):
    # one frame a thread block at the edge of the forward's shared memory,
    # X and Y rows at stride E
    x = torch.from_numpy(rng.standard_normal((67, J, emb)).astype(
        np.float32)).to(cuda_device)
    blocks = _to_port(_block_weights(rng, emb, lead=(4,), hidden=hidden))
    weights = [w.to(cuda_device) for w in blocks] + [
        torch.ones(emb, device=cuda_device),
        torch.zeros(emb, device=cuda_device)]
    out = FS.fused_spatial_stack_cuda(x, weights, heads)
    kept, _ = FS.fused_spatial_stack_cuda(x, weights, heads, keep=True)
    ref = FS.spatial_stack_reference(x, weights, heads)
    torch.cuda.synchronize()
    assert _scaled_err(out, ref) <= KERNEL_BAR
    assert torch.equal(out, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 2045, 3])
def test_cuda_temporal_keep_matches_plain(rng, cuda_device, n):
    x = torch.from_numpy(rng.standard_normal((n, 9, 832)).astype(
        np.float32)).to(cuda_device)
    weights = [w.to(cuda_device) for w in _to_port(_block_weights(rng, 832))]
    out, saved = FT.fused_temporal_block_cuda(x, weights, 8, keep=True)
    ref, ref_saved = FT.temporal_block_keep_reference(x, weights, 8)
    torch.cuda.synchronize()
    for got, want in zip((out, *saved), (ref, *ref_saved)):
        assert _scaled_err(got, want) <= KERNEL_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 2045, 3])
def test_cuda_temporal_matches_plain(rng, cuda_device, n):
    x = torch.from_numpy(rng.standard_normal((n, 9, 832)).astype(
        np.float32)).to(cuda_device)
    weights = [w.to(cuda_device) for w in _to_port(_block_weights(rng, 832))]
    out = FT.fused_temporal_block_cuda(x, weights, 8)
    ref = FT.temporal_block_reference(x, weights, 8)
    torch.cuda.synchronize()
    assert _scaled_err(out, ref) <= KERNEL_BAR
