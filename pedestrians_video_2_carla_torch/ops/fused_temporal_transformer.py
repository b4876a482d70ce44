"""One transformer block of PoseFormer's temporal stage (rf window tokens of
frame_dim = J x emb features) as CUDA entries, ``csrc/
fused_temporal_transformer.cu`` (a forward and a hand-written backward),
with their plain PyTorch version and the autograd wrapper, and the
token-major entries ``fused_temporal_block`` and ``fused_temporal_stack``.

The forward entry replaces the TPU kernels ``_fwd_kernel_tl`` (the default
token-leading layout) and ``_fwd_kernel`` (the legacy padded layout) of the
JAX package's ``ops/pallas/fused_temporal_transformer.py``: one function in
two TPU layouts, one counterpart here. On an H100 operations bound it: at
B=256, L=16 a block does 204.7 GFLOP against 145 MB of traffic, and its
four products run as 3xTF32 in the tensor cores, at fp32's accuracy: a
1.24 ms bound at that rate (3.06 ms at the fp32 peak). It is a fixed
sequence of seven launches (each LayerNorm with its statistics, the four
products as one GEMM template with bias / residual / GELU epilogues,
attention), described in the source; the GEMM's tile plan is mirrored here
(``FORWARD_GEMM``); ``fused_temporal_block_cuda.launches`` counts entry
calls, one per transformer block. The backward entry replaces the two
halves of ``_bwd_impl_slab_tl`` and ``_bwd_impl_slab`` (1,637.6 GFLOP a
block at B=1024, L=16): a fixed sequence of 13 launches whose products run
as 3xTF32 in the tensor cores (a 9.92 ms bound at that rate), described in
the source; ``fused_temporal_block_cuda_bwd.launches`` counts its calls.
When a gradient is needed the forward keeps its scratch (row statistics,
qkv, attention output, x2, the hidden before and after GELU) for it
(``temporal_block_keep_reference`` is its plain version); serving keeps
nothing and allocates no pre-GELU buffer. Windows of up to 81 tokens
(PoseFormer's published receptive fields 27 and 81): attention sizes its
shared memory per call, mirrored here (``check_limits``).

The wrappers launch the kernels for CUDA tensors and run the plain version
(and autograd of it) for CPU tensors; there is no fallback from one to the
other. The serving forward is the ``torch.library`` op
``pv2c::fused_temporal_block``, one node of an exported program.

The weights of a block are the 12-tuple ``BLOCK_WEIGHTS`` of
``ops/transformer.py`` in nn.Linear layout, qkv rows in [q; k; v] x (head,
dim) order.

Both entries take float32 or bf16 (x and the weights in one dtype). In
bf16, as the JAX kernels do with bf16 inputs, every buffer between the
launches is bf16 (y1, qkv, the attention output, x2, y2, GELU's output,
the output; the pre-GELU h kept for the backward), except the LayerNorm
statistics and the backward's dy (the gradient reaching the LayerNorms and
attention), which stay float32; the twelve products run on the bf16 tensor
cores (wgmma, float32 sums; ``csrc/wgmma_bf16.cuh``, its plan mirrored in
``BF16_GEMM``); LayerNorm, softmax, GELU and the residual adds in
float32. The backward returns dx and the weight
gradients (summed in float32) in bf16. The plain versions
(``temporal_block_reference``, ``temporal_block_keep_reference``) round
where the kernels store bf16.
"""
import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
from torch.nn import functional as F

from . import cuda_build
from .cuda_build import INT as _INT, PTR as _PTR
from .tensors import round_bf16
from .transformer import (KERNEL_DTYPES, LN_EPS, block_reference,
                          check_block_weights, check_dtypes, heads_attention,
                          plain_backward, same)

_SOURCE = cuda_build.CSRC / "fused_temporal_transformer.cu"
_SIGNATURES = {
    "pv2c_fused_temporal_block":
        [_PTR] * 20 + [_INT] * 5 + [ctypes.c_float, _PTR],
    "pv2c_fused_temporal_block_bf16":
        [_PTR] * 20 + [_INT] * 5 + [ctypes.c_float, _PTR],
    "pv2c_fused_temporal_block_bwd":
        [_PTR] * 29 + [_INT] * 5 + [ctypes.c_float, _PTR],
    "pv2c_fused_temporal_block_bwd_bf16":
        [_PTR] * 29 + [_INT] * 5 + [ctypes.c_float, _PTR],
    "pv2c_temporal_block_bwd_part_floats": [_INT] * 5,
    "pv2c_temporal_fwd_gemm_smem_bytes": [_INT],
}

#: the kernels' compiled limits (csrc/fused_temporal_transformer.cu), and
#: the shared memory one thread block may use on an H100 (sm_90)
MAX_TOKENS = 81
MAX_HEAD_WIDTH = 128
MAX_SMEM_BYTES = 232448
#: shared memory of one H100 SM, and what the hardware keeps of it for each
#: thread block
SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 233472, 1024

#: the float32 forward GEMM's plan (the source's kF* constants):
#: thread-block tile, warp tile, k-step, cp.async ring depth, thread blocks
#: an SM
FORWARD_GEMM = {"block": (128, 128), "warp": (64, 64), "k_step": 32,
                "stages": 3, "blocks_per_sm": 2}

#: the bf16 GEMM's plan, all twelve bf16 products (``csrc/wgmma_bf16.cuh``,
#: its wg::k* constants): thread-block tile, consumer warpgroups (64 rows
#: each, wgmma m64n128k16) and the producer warp's threads, k-step (128
#: bytes: the 128-byte swizzle's width), TMA ring depth, thread blocks an
#: SM, and the shared memory beside the ring (alignment slack to the
#: swizzle's 1024-byte period, the ring's mbarriers, the bias column sums'
#: rows)
BF16_GEMM = {"block": (128, 128), "consumer_warpgroups": 2, "threads": 288,
             "k_step": 64, "stages": 3, "blocks_per_sm": 2,
             "extra_bytes": (1024, 2 * 3 * 8, 2 * 4 * 64 * 4)}


def bf16_gemm_smem_bytes() -> int:
    """Dynamic shared memory of one bf16 GEMM thread block: the ring's
    stages of an A and a B tile of bf16 and what lies beside it."""
    plan = BF16_GEMM
    return (plan["stages"] * sum(plan["block"]) * plan["k_step"] * 2
            + sum(plan["extra_bytes"]))


def forward_gemm_smem_bytes(element_size: int = 4) -> int:
    """Dynamic shared memory of one forward GEMM thread block for
    ``element_size``-byte elements: float32's (4) ring of an A and a W tile
    a stage, rows padded by 16 bytes; bf16's (2) is the bf16 GEMM's."""
    if element_size == 2:
        return bf16_gemm_smem_bytes()
    plan = FORWARD_GEMM
    return plan["stages"] * sum(plan["block"]) * (
        element_size * plan["k_step"] + 16)


def attention_smem_bytes(T: int, head_width: int) -> int:
    """Dynamic shared memory of one thread block (a window and a head) of
    the attention backward, the larger of the two attention launches: q, k,
    v and do of T x head_width, the T x T probabilities and ds, all
    float32 (bf16 is widened as it is staged)."""
    return 4 * (4 * T * head_width + 2 * T * T)


def check_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                num_heads: int) -> int:
    """Shapes and types of a block call; returns its MLP hidden width."""
    if x.ndim != 3:
        raise ValueError(f"x must be (N, T, D), got {tuple(x.shape)}")
    D = x.shape[-1]
    hidden = check_block_weights(weights, D)
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"{num_heads} heads do not divide width {D}")
    check_dtypes("the temporal block", x, weights)
    return hidden


def temporal_block_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                             num_heads: int) -> torch.Tensor:
    """The plain PyTorch version: (N, T, D) -> (N, T, D); in bf16 the
    output of :func:`temporal_block_keep_reference`."""
    if x.dtype == torch.bfloat16:
        return temporal_block_keep_reference(x, weights, num_heads)[0]
    return block_reference(x, weights, num_heads)


def temporal_block_keep_reference(x: torch.Tensor,
                                  weights: Sequence[torch.Tensor],
                                  num_heads: int):
    """The plain version of the training forward: ``(out, saved)``, saved
    the scratch ``fused_temporal_block_cuda(..., keep=True)`` keeps, in its
    layout: stats (mu1, inv1, mu2, inv2 of the M = N T rows, 4 M), qkv
    (M, 3D), the attention output before proj (M, D), x2 (M, D), the
    pre-GELU hidden h and GELU(h) (M, hidden). In bf16 it computes in
    float32 on the bf16 values and rounds to bf16 what the kernels store
    in bf16 (y1, qkv, the attention output, x2, y2, h, GELU(h), the
    output; the statistics stay float32), with the identity as the
    rounding's gradient; out and the kept tensors but the statistics are
    returned in bf16."""
    dtype = x.dtype
    keep = round_bf16 if dtype == torch.bfloat16 else same
    if dtype == torch.bfloat16:
        x, weights = x.float(), [w.float() for w in weights]
    (ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
     ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b) = weights
    N, T, D = x.shape
    M = N * T

    def ln(v, s, b):
        mu = v.mean(-1, keepdim=True)
        inv = torch.rsqrt(((v * v).mean(-1, keepdim=True) - mu * mu
                           ).clamp_min(0.0) + LN_EPS)
        return keep((v - mu) * inv * s + b), mu.reshape(M), inv.reshape(M)

    y1, mu1, inv1 = ln(x, ln1_s, ln1_b)
    qkv = keep(F.linear(y1, qkv_w, qkv_b))
    attn = keep(heads_attention(qkv, num_heads))
    x2 = keep(x + F.linear(attn, proj_w, proj_b))
    y2, mu2, inv2 = ln(x2, ln2_s, ln2_b)
    h = F.linear(y2, fc1_w, fc1_b)
    mlp = keep(F.gelu(h))
    out = keep(x2 + F.linear(mlp, fc2_w, fc2_b)).to(dtype)
    saved = (torch.cat([mu1, inv1, mu2, inv2]),
             *(t.reshape(M, -1).to(dtype) for t in (qkv, attn, x2, keep(h),
                                                     mlp)))
    return out, saved


def check_limits(T: int, D: int, num_heads: int, hidden: int,
                 element_size: int = 4) -> None:
    """The kernels' limits on a block's shape for ``element_size``-byte
    elements (4: float32, 2: bf16); raises ValueError for one they do not
    take. Widths are multiples of 8 for both: 16-byte rows for the
    float32 GEMMs' 16-byte copies and for the bf16 GEMM's TMA tensor maps,
    whose row strides are multiples of 16 bytes."""
    hd = D // num_heads
    if T > MAX_TOKENS or hd > MAX_HEAD_WIDTH or D % 8 or hidden % 8:
        raise ValueError(
            f"the temporal kernel takes T <= {MAX_TOKENS}, head width <= "
            f"{MAX_HEAD_WIDTH} and widths that are multiples of 8; got T={T}, "
            f"D={D}, {num_heads} heads, hidden {hidden}")
    smem = attention_smem_bytes(T, hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"T={T} at head width {hd} needs {smem} bytes of "
                         f"shared memory for the attention backward, more "
                         f"than {MAX_SMEM_BYTES}")
    gemm = forward_gemm_smem_bytes(element_size)
    if gemm > MAX_SMEM_BYTES:
        raise ValueError(f"the GEMM's ring needs {gemm} bytes of shared "
                         f"memory, more than {MAX_SMEM_BYTES}")


def _check_limits(x, tensors, num_heads, hidden) -> None:
    T, D = x.shape[1:]
    check_limits(T, D, num_heads, hidden, x.element_size())
    if any(t.data_ptr() % 16 for t in (x, *tensors)):
        raise ValueError("the temporal kernel needs 16-byte aligned tensors")


def _library():
    return cuda_build.load_library(_SOURCE, _SIGNATURES)


def fused_temporal_block_cuda(x: torch.Tensor,
                              weights: Sequence[torch.Tensor],
                              num_heads: int, keep: bool = False):
    """Launch the block on float32 or bf16 contiguous CUDA tensors:
    (N, T, D) -> (N, T, D) in x's dtype; with ``keep``, ``(out, saved)``,
    ``saved`` the scratch the backward takes (stats (4 N T, float32), and
    in x's dtype qkv (N T, 3D), attn (N T, D), x2 (N T, D), h (N T, hidden)
    before GELU, mlp (N T, hidden) after). Adds one to
    ``fused_temporal_block_cuda.launches`` per call (and, for bf16, to
    ``.bf16_launches``)."""
    hidden = check_block(x, weights, num_heads)
    device = cuda_build.check_cuda_tensors(
        "fused_temporal_block_cuda", dtypes=KERNEL_DTYPES, x=x,
        **{f"weights[{i}]": w for i, w in enumerate(weights)})
    N, T, D = x.shape
    _check_limits(x, weights, num_heads, hidden)
    out = torch.empty_like(x)
    M = N * T
    bf16 = x.dtype == torch.bfloat16
    empty = functools.partial(torch.empty, dtype=x.dtype, device=device)
    stats = torch.empty(4 * M, dtype=torch.float32, device=device)
    qkv, attn, x2, mlp = (empty((M, 3 * D)), empty((M, D)), empty((M, D)),
                          empty((M, hidden)))
    h = empty((M, hidden)) if keep else None
    if M:
        lib = _library()
        entry = lib.pv2c_fused_temporal_block_bf16 if bf16 \
            else lib.pv2c_fused_temporal_block
        with torch.cuda.device(device):
            err = entry(
                x.data_ptr(), out.data_ptr(),
                *(w.data_ptr() for w in weights),
                *(t.data_ptr() for t in (stats, qkv, attn, x2, mlp)),
                None if h is None else h.data_ptr(), N, T, D, num_heads,
                hidden, float(D // num_heads) ** -0.5,
                torch.cuda.current_stream(device).cuda_stream)
        cuda_build.check_launch(err, "pv2c_fused_temporal_block")
        fused_temporal_block_cuda.launches += 1
        fused_temporal_block_cuda.bf16_launches += bf16
    return (out, (stats, qkv, attn, x2, h, mlp)) if keep else out


cuda_build.counted("fused_temporal_block", fused_temporal_block_cuda,
                   bf16=True)


def fused_temporal_block_cuda_bwd(x: torch.Tensor,
                                  weights: Sequence[torch.Tensor],
                                  saved: Sequence[torch.Tensor],
                                  g: torch.Tensor, num_heads: int
                                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Launch the backward on float32 or bf16 contiguous CUDA tensors: the
    forward's input x (N, T, D), its weights, the ``saved`` scratch of
    ``fused_temporal_block_cuda(..., keep=True)`` and the output's
    cotangent g, in x's dtype (the statistics float32) -> ``(dx, [12
    weight gradients])``, each in its weight's shape and x's dtype. Adds
    one to ``fused_temporal_block_cuda_bwd.launches`` per call (and, for
    bf16, to ``.bf16_launches``)."""
    hidden = check_block(x, weights, num_heads)
    N, T, D = x.shape
    M = N * T
    shapes = ((4 * M,), (M, 3 * D), (M, D), (M, D), (M, hidden), (M, hidden))
    if len(saved) != len(shapes) or g.shape != x.shape:
        raise ValueError("the backward takes the forward's six saved tensors "
                         "and a cotangent of x's shape")
    for name, t, shape in zip(("stats", "qkv", "attn", "x2", "h", "mlp"),
                              saved, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != (torch.float32 if name == "stats" else x.dtype):
            raise TypeError(f"{name} has dtype {t.dtype}")
    check_dtypes("the temporal backward", x, (g,))
    device = cuda_build.check_cuda_tensors(
        "fused_temporal_block_cuda_bwd", dtypes=KERNEL_DTYPES, x=x, g=g,
        **{f"weights[{i}]": w for i, w in enumerate(weights)},
        **{f"saved[{i}]": t for i, t in enumerate(saved)})
    _check_limits(x, (g, *weights, *saved), num_heads, hidden)
    sizes = [w.numel() for w in weights]
    if M == 0:
        return torch.zeros_like(x), [torch.zeros_like(w) for w in weights]
    bf16 = x.dtype == torch.bfloat16
    empty = functools.partial(torch.empty, dtype=x.dtype, device=device)
    dx, flat = torch.empty_like(x), empty(sum(sizes))
    # dh, dy (float32), dx2, dqkv, y1, y2
    scratch = (empty((M, hidden)),
               torch.empty((M, D), dtype=torch.float32, device=device),
               empty((M, D)), empty((M, 3 * D)), empty((M, D)),
               empty((M, D)))
    lib = _library()
    with torch.cuda.device(device):
        floats = lib.pv2c_temporal_block_bwd_part_floats(
            N, T, D, hidden, x.element_size())
        if floats < 0:
            cuda_build.check_launch(-floats,
                                    "pv2c_temporal_block_bwd_part_floats")
        part = torch.empty(floats, dtype=torch.float32, device=device)
        entry = lib.pv2c_fused_temporal_block_bwd_bf16 if bf16 \
            else lib.pv2c_fused_temporal_block_bwd
        err = entry(
            x.data_ptr(), *(w.data_ptr() for w in weights),
            *(t.data_ptr() for t in saved), g.data_ptr(), dx.data_ptr(),
            flat.data_ptr(), *(t.data_ptr() for t in scratch),
            part.data_ptr(), N, T, D, num_heads, hidden,
            float(D // num_heads) ** -0.5,
            torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check_launch(err, "pv2c_fused_temporal_block_bwd")
    fused_temporal_block_cuda_bwd.launches += 1
    fused_temporal_block_cuda_bwd.bf16_launches += bf16
    return dx, [t.view_as(w) for t, w in zip(flat.split(sizes), weights)]


cuda_build.counted("fused_temporal_block_bwd", fused_temporal_block_cuda_bwd,
                   bf16=True)


@torch.library.custom_op("pv2c::fused_temporal_block", mutates_args=(),
                         device_types="cpu")
def fused_temporal_block_op(x: torch.Tensor, weights: List[torch.Tensor],
                            num_heads: int) -> torch.Tensor:
    """Rows 6 and 8's serving entry as a ``torch.library`` op (one node of
    an exported graph): ``fused_temporal_block_cuda`` on the card, the
    plain version on the CPU."""
    check_block(x, weights, num_heads)
    return temporal_block_reference(x, weights, num_heads)


@fused_temporal_block_op.register_kernel("cuda")
def _(x, weights, num_heads):
    return fused_temporal_block_cuda(x, weights, num_heads)


@fused_temporal_block_op.register_fake
def _(x, weights, num_heads):
    check_block(x, weights, num_heads)
    return torch.empty_like(x)


class FusedTemporalBlock(torch.autograd.Function):
    """Kernel forward and kernel backward (CUDA), or the plain forward and
    autograd of it (CPU), as the JAX package's custom VJP. ``keep``: a
    gradient will be asked for, so the kernel forward keeps its scratch;
    without it the forward is ``pv2c::fused_temporal_block``."""

    @staticmethod
    def forward(ctx, x, num_heads, keep, *weights):
        ctx.num_heads = num_heads
        if keep and x.device.type == "cuda":
            out, saved = fused_temporal_block_cuda(x, weights, num_heads,
                                                   keep=True)
            ctx.save_for_backward(x, *weights, *saved)
            return out
        if keep:
            ctx.save_for_backward(x, *weights)
        return fused_temporal_block_op(x, list(weights), num_heads)

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        weights, saved = rest[:12], rest[12:]
        if x.device.type == "cuda":
            dx, dws = fused_temporal_block_cuda_bwd(
                x, weights, saved, g.contiguous(), ctx.num_heads)
        else:
            dx, dws = plain_backward(temporal_block_reference, x, weights, g,
                                     ctx.num_heads)
        return (dx, None, None, *dws)


def fused_temporal_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         num_heads: int) -> torch.Tensor:
    """One pre-norm transformer block on (N, T, D) float32 or bf16 window
    tokens, fused; ``weights`` as the module docstring says, in x's dtype.
    Differentiable in x and every weight."""
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *weights))
    return FusedTemporalBlock.apply(x.contiguous(), num_heads, keep,
                                    *(w.contiguous() for w in weights))


def fused_temporal_stack(x: torch.Tensor,
                         weights_list: Sequence[Sequence[torch.Tensor]],
                         num_heads: int) -> torch.Tensor:
    """A stack of blocks, one :func:`fused_temporal_block` each (the port
    keeps the (N, T, D) layout between blocks, so there is no layout
    round-trip to save)."""
    for weights in weights_list:
        x = fused_temporal_block(x, weights, num_heads)
    return x
