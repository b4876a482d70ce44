"""PoseFormer's spatial transformer stack (depth pre-norm blocks and the
final LayerNorm over the J joint tokens of each frame) as CUDA kernels,
``csrc/fused_spatial_transformer.cu``: a forward and a hand-written
backward, with their plain PyTorch version and the autograd wrapper.

The forward replaces the TPU kernel ``_fwd_kernel`` of the JAX package's
``ops/pallas/fused_spatial_transformer.py`` (``fused_spatial_stack``). On an
H100 operations bound it: at B=256, L=16 it does 8.40 GFLOP (51 us at the
3xTF32 rate of the tensor cores, where its dense products run; its
attention runs on the CUDA cores) against about 27 MB of traffic;
its design (a warp a frame, resident in shared memory through the whole
stack, the products as ``mma.sync`` tiles) is described in the source.
The backward replaces ``_bwd_kernel``
(``_fused_bwd_impl``): dx and the 14 weight gradients (67.18 GFLOP at
B=1024, L=16, a 1.00 ms bound) from the residuals the training forward
keeps, two launches per depth block in reverse, per-thread-block partial
weight gradients summed in a fixed order. The shared-memory layouts and the
tiles they allow are mirrored here (``kernel_tiles``), so that the limits
are known without a card.

``fused_spatial_stack`` launches the kernels for CUDA tensors and runs the
plain version (and autograd of it) for CPU tensors; there is no fallback
from one to the other. Its serving forward is the ``torch.library`` op
``pv2c::fused_spatial_stack``, one node of an exported program.

The weights are a 14-tuple: the 12 block weights of ``ops/transformer.py``
(``BLOCK_WEIGHTS``, nn.Linear layout) each stacked over depth, then the
final LayerNorm's scale and bias (E,).

Both entries take float32 or bf16 (x and the weights in one dtype); bf16
has kernels of its own. In bf16, as the JAX kernels do with bf16 inputs:
the forward runs each product on bf16 tensor-core tiles, its activation
operand rounded to bf16 where the JAX kernel's ``_dense`` casts it, with
LayerNorm, attention, GELU and the residual stream in float32, the output
stored in bf16; the residuals the training forward keeps stay float32;
the backward's products are fp32-accurate (3xTF32 tensor-core tiles, as the
JAX backward's dots are float32: ``spatial_stack_bwd_reference`` with
``dx_product_tf32x2`` / ``dw_product_tf32x3`` models them) and it returns
dx and the weight gradients (summed in float32) in bf16. The bf16 kernels'
shared-memory plans differ from the float32 ones and are mirrored here
too (``bf16_forward_smem_bytes``, ``mlp_bwd_bf16_smem_bytes``,
``attn_bwd_bf16_smem_bytes``; ``kernel_tiles(..., element_size=2)``).
``spatial_stack_reference`` is the plain version of either forward,
``spatial_stack_keep_reference`` of the training forward and its
residuals, ``spatial_stack_bwd_reference`` of the backward's algorithm.
"""
import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from . import cuda_build
from .cuda_build import INT as _INT, PTR as _PTR
from torch.nn import functional as F

from .tensors import round_bf16, round_tf32
from .transformer import (KERNEL_DTYPES, LN_EPS, block_reference,
                          check_block_weights, check_dtypes, heads_attention,
                          layer_norm, plain_backward)

_SOURCE = cuda_build.CSRC / "fused_spatial_transformer.cu"
_SIGNATURES = {
    "pv2c_fused_spatial_stack":
        [_PTR] * 22 + [_INT] * 7 + [ctypes.c_float, _PTR],
    "pv2c_fused_spatial_stack_bf16":
        [_PTR] * 22 + [_INT] * 7 + [ctypes.c_float, _PTR],
    "pv2c_spatial_stack_smem_bytes": [_INT] * 5,
    "pv2c_spatial_mlp_bwd_smem_bytes": [_INT] * 3,
    "pv2c_spatial_attn_bwd_smem_bytes": [_INT] * 4,
    "pv2c_fused_spatial_stack_bwd":
        [_PTR] * 25 + [_INT] * 9 + [ctypes.c_float, _PTR],
    "pv2c_fused_spatial_stack_bwd_bf16":
        [_PTR] * 26 + [_INT] * 9 + [ctypes.c_float, _PTR],
    "pv2c_spatial_stack_bwd_grid": [_INT] * 6,
    "pv2c_spatial_stack_bf16_smem_bytes": [_INT] * 5,
    "pv2c_spatial_mlp_bwd_bf16_smem_bytes": [_INT] * 3,
    "pv2c_spatial_attn_bwd_bf16_smem_bytes": [_INT] * 4,
    "pv2c_spatial_stack_bwd_grid_bf16": [_INT] * 6,
}

#: the kernels' compiled limits (csrc/fused_spatial_transformer.cu)
MAX_TOKENS = 32
MAX_HEAD_WIDTH = 32
MAX_WIDTH = 128
#: shared memory a thread block may use on an H100 (sm_90), and the most
#: each of two thread blocks on one SM may use (233,472 bytes an SM, less
#: 1 KB a thread block, halved)
MAX_SMEM_BYTES = 232448
TWO_PER_SM_BYTES = 115712
#: the tiles tried, largest first: the forward's frames (warps) a thread
#: block, the backward's attention half's frames a thread block and its MLP
#: half's rows
FORWARD_TILES = (4, 3, 2, 1)
FRAME_TILES = (4, 3, 2, 1)
ROW_TILES = (128, 96, 64, 32, 16, 8, 4)
#: the bf16 kernels' tiles: the forward's frames (at most 5 warps a thread
#: block, which keeps two thread blocks an SM within the registers) and the
#: backward's MLP half's rows (multiples of the tensor-core tiles' 16 rows)
FORWARD_TILES_BF16 = (5, 4, 3, 2, 1)
ROW_TILES_BF16 = (128, 112, 96, 80, 64, 48, 32, 16)
_WPAD = 8
#: warps of a backward thread block (kWarps)
_WARPS = 8


def _pad4(v: int) -> int:
    return (v + 3) & ~3


def _round8(v: int) -> int:
    return (v + 7) & ~7


def _round16(v: int) -> int:
    return (v + 15) & ~15


def forward_smem_bytes(J: int, E: int, hidden: int, frames: int,
                       pad: Optional[int] = None) -> int:
    """Shared memory of one forward thread block at ``frames`` frames (the
    source's ``fwd_layout``: each frame's X, Y and Z rows, then the
    weights and vectors, rows ``pad`` floats wider than their 8-rounded
    widths, X's and Y's E wide at ``pad`` 0; by default 4, or 0 where that
    layout would not fit, as the source picks)."""
    ke, kh, nq = _round8(E), _round8(hidden), _round8(3 * E)
    for p in (4, 0) if pad is None else (pad,):
        ldx = ke + p if p else E
        ldw, ldz, ldh = ke + p, max(nq, kh) + p, kh + p
        act = frames * J * (2 * ldx + ldz)
        end = act + (nq + ke + kh) * ldw + E * ldh + 6 * ke + nq + kh
        reach = act + (MAX_TOKENS - J) * ldz
        if 4 * max(end, reach) <= MAX_SMEM_BYTES:
            break
    return 4 * max(end, reach)


def bf16_forward_smem_bytes(J: int, E: int, hidden: int,
                            frames: int) -> int:
    """Shared memory of one thread block of the bf16 forward at ``frames``
    frames (the source's ``bf_layout``: each frame's X (float32), Y (bf16)
    and Z (float32, G over it in bf16), then the bf16 weights and the
    float32 vectors; E and hidden rounded up to 16, 3E to 8)."""
    ke, kh, nq = _round16(E), _round16(hidden), _round8(3 * E)
    ldx, ldy, ldg, ldw, ldh = ke + 4, ke + 8, kh + 8, ke + 8, kh + 8
    ldz = max(nq + 4, ldg // 2)
    act = frames * J * (ldx + ldy // 2 + ldz)
    end = act + (nq + ke + kh) * ldw // 2 + ke * ldh // 2 + 6 * ke + nq + kh
    return 4 * max(end, act + (MAX_TOKENS - J) * ldz)


def _act_ld(w: int) -> int:
    """The bf16 backward's activation row stride (``act_ld``), floats."""
    return _round8(w) + 4


def _wt_ld(n: int) -> int:
    """The bf16 backward's staged weight row stride (``wt_ld``), bf16
    elements."""
    r = _round8(n)
    return r + 8 if r % 16 == 0 else r


def mlp_bwd_bf16_smem_bytes(E: int, hidden: int, rows: int) -> int:
    """Shared memory of one thread block of the bf16 backward's MLP half
    at ``rows`` rows (``mlp_tc_layout``)."""
    le, lh = _act_ld(E), _act_ld(hidden)
    floats = (rows * (le + lh + max(lh, le) + le) + 2 * _pad4(rows)
              + (_round8(E) * _wt_ld(hidden) + _round8(hidden) * _wt_ld(E))
              // 2 + 2 * _round8(E) + 2 * _WARPS * E)
    return 4 * floats


def attn_bwd_bf16_smem_bytes(J: int, E: int, num_heads: int,
                             frames: int) -> int:
    """Shared memory of one thread block of the bf16 backward's attention
    half at ``frames`` frames, their rows padded to 16 (``attn_tc_layout``)."""
    rows = _round16(frames * J)
    le, lq = _act_ld(E), _act_ld(3 * E)
    floats = (rows * (3 * le + E + 2 * lq) + 2 * _pad4(rows)
              + _pad4(3 * frames * num_heads * J)
              + (_round8(E) + _round8(3 * E)) * _wt_ld(E) // 2
              + 2 * _round8(E) + 2 * _WARPS * E)
    return 4 * floats


def mlp_bwd_smem_bytes(E: int, hidden: int, rows: int) -> int:
    """Shared memory of one thread block of the backward's MLP half at
    ``rows`` rows (``mlp_layout``)."""
    floats = (2 * rows * E + 2 * rows * hidden + _pad4(rows)
              + hidden * (E + _WPAD) + E * (hidden + _WPAD) + 2 * E
              + _pad4(2 * E * hidden + E + hidden) + 16 * E)
    return 4 * floats


def attn_bwd_smem_bytes(J: int, E: int, num_heads: int, frames: int) -> int:
    """Shared memory of one thread block of the backward's attention half
    at ``frames`` frames (``attn_layout``)."""
    rows = _pad4(frames * J)
    floats = (10 * rows * E + _pad4(rows) + _pad4(3 * frames * num_heads * J)
              + 4 * E * (E + _WPAD) + 2 * E
              + _pad4(4 * E * E + 4 * E) + 16 * E)
    return 4 * floats


def _pick(tiles, size, what, limits=(TWO_PER_SM_BYTES, MAX_SMEM_BYTES)):
    """The largest tile within the first of ``limits`` that any tile meets:
    room for a second thread block on the SM, else room for one."""
    for limit in limits:
        for t in tiles:
            if size(t) <= limit:
                return t
    raise ValueError(f"{what} needs {size(tiles[-1])} bytes of shared memory "
                     f"per thread block at its smallest tile, more than "
                     f"{MAX_SMEM_BYTES}")


def _library():
    return cuda_build.load_library(_SOURCE, _SIGNATURES)


def check_stack(x: torch.Tensor, weights: Sequence[torch.Tensor],
                num_heads: int) -> int:
    """Shapes and types of a stack call; returns its MLP hidden width."""
    if x.ndim != 3:
        raise ValueError(f"x must be (N, J, E), got {tuple(x.shape)}")
    E = x.shape[-1]
    if len(weights) != 14:
        raise ValueError(f"expected 14 stack weights, got {len(weights)}")
    hidden = check_block_weights(weights[:12], E, stacked=True)
    for name, w in (("lnf_s", weights[12]), ("lnf_b", weights[13])):
        if tuple(w.shape) != (E,):
            raise ValueError(f"{name} must be {(E,)}, got {tuple(w.shape)}")
    if num_heads < 1 or E % num_heads:
        raise ValueError(f"{num_heads} heads do not divide width {E}")
    check_dtypes("the spatial stack", x, weights)
    return hidden


def spatial_stack_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                            num_heads: int) -> torch.Tensor:
    """The plain PyTorch version: (N, J, E) -> (N, J, E). In bf16 it
    computes in float32 on the bf16 values, each product's activation
    operand rounded to bf16 (the JAX kernel's ``_dense``), and stores the
    output in bf16; autograd of it is then the float32 backward of the
    rounded forward, its gradients cast to bf16."""
    dtype = x.dtype
    operand = round_bf16 if dtype == torch.bfloat16 else None
    if operand is not None:
        x, weights = x.float(), [w.float() for w in weights]
    *blocks, lnf_s, lnf_b = weights
    for d in range(blocks[0].shape[0]):
        block = [w[d] for w in blocks]
        x = block_reference(x, block, num_heads) if operand is None \
            else block_reference(x, block, num_heads, operand=operand)
    return layer_norm(x, lnf_s, lnf_b).to(dtype)


def _stats(x: torch.Tensor):
    """LayerNorm's mean and rsqrt(var + eps) over the last axis, flax's
    formula (var = max(mean(x^2) - mean(x)^2, 0)), as the kernels take
    them."""
    mu = x.mean(-1)
    var = ((x * x).mean(-1) - mu * mu).clamp_min(0.0)
    return mu, torch.rsqrt(var + LN_EPS)


def spatial_stack_keep_reference(x: torch.Tensor,
                                 weights: Sequence[torch.Tensor],
                                 num_heads: int):
    """The plain version of the training forward: ``(out, saved)``, out as
    :func:`spatial_stack_reference` gives it and ``saved`` the residuals
    (``SAVED``, float32, ``saved_shapes``) the kernel keeps for the
    backward; bf16 as that function rounds."""
    dtype = x.dtype
    op = round_bf16 if dtype == torch.bfloat16 else (lambda t: t)
    x = x.float()
    weights = [w.float() for w in weights]
    *blocks, lnf_s, lnf_b = weights
    N, J, E = x.shape
    depth = blocks[0].shape[0]
    kept = {k: [] for k in SAVED}
    for d in range(depth):
        (ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b, fc1_w,
         fc1_b, fc2_w, fc2_b) = [w[d] for w in blocks]
        mu1, inv1 = _stats(x)
        qkv = F.linear(op(layer_norm(x, ln1_s, ln1_b)), qkv_w, qkv_b)
        o = heads_attention(qkv, num_heads)
        x2 = x + F.linear(op(o), proj_w, proj_b)
        mu2, inv2 = _stats(x2)
        h = F.linear(op(layer_norm(x2, ln2_s, ln2_b)), fc1_w, fc1_b)
        x = x2 + F.linear(op(F.gelu(h)), fc2_w, fc2_b)
        kept["stats"].append(torch.stack([mu1, inv1, mu2, inv2]).reshape(
            4, N * J))
        for k, v in (("qkv", qkv), ("o", o), ("x2", x2), ("h", h),
                     ("xs", x)):
            kept[k].append(v.reshape(N * J, -1))
    shapes = saved_shapes(depth, N * J, E, blocks[8].shape[1])
    saved = [torch.stack(kept[k]) if kept[k] else x.new_zeros(shape)
             for k, shape in zip(SAVED, shapes)]
    return layer_norm(x, lnf_s, lnf_b).to(dtype), saved


def _split_tf32(t: torch.Tensor):
    big = round_tf32(t)
    return big, round_tf32(t - big)


def dx_product_tf32x2(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The bf16 backward's dX = a w on the tensor cores: a (float32) split
    into TF32 big and small parts, w (bf16 values, exact in TF32) taken
    whole, two products summed small first."""
    big, small = _split_tf32(a)
    return small @ w + big @ w


def dw_product_tf32x3(dy: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """The bf16 backward's dW = dy^T act on the tensor cores, both float32
    operands split (3xTF32): the two small-part products first, then the
    big one."""
    dyb, dys = _split_tf32(dy)
    ab, as_ = _split_tf32(act)
    return dys.t() @ ab + dyb.t() @ as_ + dyb.t() @ ab


def _ln_bwd(dy, xh, inv, s):
    dxh = dy * s
    return inv[:, None] * (dxh - dxh.mean(-1, keepdim=True)
                           - xh * (dxh * xh).mean(-1, keepdim=True))


def _dgelu(v):
    return 0.5 * (1.0 + torch.erf(v * 0.5 ** 0.5)) + v * torch.exp(
        -0.5 * v * v) * (2.0 * torch.pi) ** -0.5


def spatial_stack_bwd_reference(x: torch.Tensor,
                                weights: Sequence[torch.Tensor],
                                saved: Sequence[torch.Tensor],
                                g: torch.Tensor, num_heads: int,
                                dx_product=torch.matmul,
                                dw_product=lambda dy, a: dy.t() @ a):
    """The backward's algorithm in plain PyTorch, float32, from the
    training forward's residuals: ``(dx, [14 weight gradients])``, as the
    kernels and the JAX kernel's ``_bwd_kernel`` run it (LayerNorm's
    statistics from ``saved``, the products' activations recomputed in
    float32, the attention's probabilities from qkv). ``dx_product(a, w)``
    and ``dw_product(dy, act)`` take each dense product (by default plain
    float32 matmuls; ``dx_product_tf32x2`` and ``dw_product_tf32x3`` model
    the bf16 kernel's tensor-core passes)."""
    x, g = x.float(), g.float()
    weights = [w.float() for w in weights]
    *blocks, lnf_s, lnf_b = weights
    stats, qkv_s, o_s, x2_s, h_s, xs_s = saved
    N, J, E = x.shape
    depth = blocks[0].shape[0]
    xin = [x.reshape(-1, E)] + [xs_s[d] for d in range(depth)]
    xl = xin[depth]
    mu, inv = _stats(xl)
    xh = (xl - mu[:, None]) * inv[:, None]
    gf = g.reshape(-1, E)
    grads = [[None] * depth for _ in range(12)]
    d_lnf = [(gf * xh).sum(0), gf.sum(0)]
    dx = _ln_bwd(gf, xh, inv, lnf_s)
    for d in range(depth - 1, -1, -1):
        (ln1_s, ln1_b, qkv_w, _, proj_w, _, ln2_s, ln2_b, fc1_w, _, fc2_w,
         _) = [w[d] for w in blocks]
        mu1, inv1, mu2, inv2 = stats[d]
        # the MLP half
        du, h = dx, h_s[d]
        grads[10][d] = dw_product(du, F.gelu(h))
        grads[11][d] = du.sum(0)
        dh = dx_product(du, fc2_w) * _dgelu(h)
        xh2 = (x2_s[d] - mu2[:, None]) * inv2[:, None]
        grads[8][d] = dw_product(dh, xh2 * ln2_s + ln2_b)
        grads[9][d] = dh.sum(0)
        dy2 = dx_product(dh, fc1_w)
        grads[6][d], grads[7][d] = (dy2 * xh2).sum(0), dy2.sum(0)
        dx2 = du + _ln_bwd(dy2, xh2, inv2, ln2_s)
        # the attention half
        grads[4][d] = dw_product(dx2, o_s[d])
        grads[5][d] = dx2.sum(0)
        do = dx_product(dx2, proj_w)
        qkv = qkv_s[d].reshape(N, J, 3 * E).detach().requires_grad_(True)
        with torch.enable_grad():
            dqkv, = torch.autograd.grad(heads_attention(qkv, num_heads), qkv,
                                        do.reshape(N, J, E))
        dqkv = dqkv.reshape(-1, 3 * E)
        xh1 = (xin[d] - mu1[:, None]) * inv1[:, None]
        grads[2][d] = dw_product(dqkv, xh1 * ln1_s + ln1_b)
        grads[3][d] = dqkv.sum(0)
        dy1 = dx_product(dqkv, qkv_w)
        grads[0][d], grads[1][d] = (dy1 * xh1).sum(0), dy1.sum(0)
        dx = dx2 + _ln_bwd(dy1, xh1, inv1, ln1_s)
    dws = [torch.stack(gs) if depth else w.new_zeros(w.shape)
           for gs, w in zip(grads, blocks)] + d_lnf
    return dx.reshape(N, J, E), dws


def kernel_tiles(J: int, E: int, num_heads: int, hidden: int,
                 element_size: int = 4) -> Tuple[int, int, int]:
    """The kernels' compiled limits; returns their tiles for elements of
    ``element_size`` bytes (4: the float32 kernels; 2: the bf16 ones):
    (frames (warps) a thread block of the forward, rows a tile of the
    backward's MLP half, frames a tile of its attention half). Raises
    ValueError for a shape the kernels do not take."""
    if J > MAX_TOKENS or E > MAX_WIDTH or E // num_heads > MAX_HEAD_WIDTH \
            or E % 4 or hidden % 4:
        raise ValueError(
            f"the spatial kernel takes J <= {MAX_TOKENS}, E <= {MAX_WIDTH}, "
            f"head width <= {MAX_HEAD_WIDTH} and widths that are multiples "
            f"of 4; got J={J}, E={E}, {num_heads} heads, hidden {hidden}")
    if element_size == 2:
        return (_pick(FORWARD_TILES_BF16,
                      lambda f: bf16_forward_smem_bytes(J, E, hidden, f),
                      "the bf16 spatial forward"),
                _pick(ROW_TILES_BF16,
                      lambda r: mlp_bwd_bf16_smem_bytes(E, hidden, r),
                      "the bf16 spatial backward's MLP half"),
                _pick(FRAME_TILES,
                      lambda f: attn_bwd_bf16_smem_bytes(J, E, num_heads, f),
                      "the bf16 spatial backward's attention half"))
    if forward_smem_bytes(J, E, hidden, 1, pad=4) <= MAX_SMEM_BYTES:
        fwd = _pick(FORWARD_TILES,
                    lambda f: forward_smem_bytes(J, E, hidden, f, pad=4),
                    "the spatial forward")
    else:  # one frame in the layout without the padding
        fwd = _pick((1,), lambda f: forward_smem_bytes(J, E, hidden, f),
                    "the spatial forward", limits=(MAX_SMEM_BYTES,))
    return (fwd,
            _pick(ROW_TILES, lambda r: mlp_bwd_smem_bytes(E, hidden, r),
                  "the spatial backward's MLP half"),
            _pick(FRAME_TILES,
                  lambda f: attn_bwd_smem_bytes(J, E, num_heads, f),
                  "the spatial backward's attention half"))


def _check_aligned(tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the spatial kernel needs 16-byte aligned tensors")


#: the residuals the training forward keeps per depth block (``saved``)
SAVED = ("stats", "qkv", "o", "x2", "h", "xs")


def saved_shapes(depth: int, M: int, E: int, hidden: int):
    """Shapes of the ``saved`` tensors for M = N J token rows: the
    LayerNorm statistics (mu1, inv1, mu2, inv2), qkv, the attention output,
    x2, the pre-GELU hidden and the block's output."""
    return [(depth, 4, M), (depth, M, 3 * E), (depth, M, E), (depth, M, E),
            (depth, M, hidden), (depth, M, E)]


def fused_spatial_stack_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                             num_heads: int, keep: bool = False):
    """Launch the kernel on float32 or bf16 contiguous CUDA tensors:
    (N, J, E) -> (N, J, E) in x's dtype; with ``keep``, ``(out, saved)``,
    ``saved`` the residuals the backward takes (``SAVED``, about 260
    floats a token row and depth block, float32 in both dtypes). Adds one
    to ``fused_spatial_stack_cuda.launches`` per launch (and, for bf16, to
    ``fused_spatial_stack_cuda.bf16_launches``)."""
    hidden = check_stack(x, weights, num_heads)
    device = cuda_build.check_cuda_tensors(
        "fused_spatial_stack_cuda", dtypes=KERNEL_DTYPES, x=x,
        **{f"weights[{i}]": w for i, w in enumerate(weights)})
    N, J, E = x.shape
    depth = weights[0].shape[0]
    frames, _, _ = kernel_tiles(J, E, num_heads, hidden, x.element_size())
    _check_aligned((x, *weights))
    out = torch.empty_like(x)
    saved = [torch.empty(s, dtype=torch.float32, device=device)
             for s in saved_shapes(depth, N * J, E, hidden)] if keep else None
    if N:
        lib = _library()
        bf16 = x.dtype == torch.bfloat16
        entry = lib.pv2c_fused_spatial_stack_bf16 if bf16 \
            else lib.pv2c_fused_spatial_stack
        with torch.cuda.device(device):
            err = entry(
                x.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in weights),
                *(t.data_ptr() for t in saved) if keep else (None,) * 6,
                N, J, E, num_heads, hidden, depth, frames,
                float(E // num_heads) ** -0.5,
                torch.cuda.current_stream(device).cuda_stream)
        cuda_build.check_launch(err, "pv2c_fused_spatial_stack")
        fused_spatial_stack_cuda.launches += 1
        fused_spatial_stack_cuda.bf16_launches += bf16
    return (out, saved) if keep else out


cuda_build.counted("fused_spatial_stack", fused_spatial_stack_cuda, bf16=True)


def fused_spatial_stack_cuda_bwd(x: torch.Tensor,
                                 weights: Sequence[torch.Tensor],
                                 saved: Sequence[torch.Tensor],
                                 g: torch.Tensor, num_heads: int
                                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Launch the backward on float32 or bf16 contiguous CUDA tensors: the
    forward's input x (N, J, E), its weights, the ``saved`` residuals of
    ``fused_spatial_stack_cuda(..., keep=True)`` (float32) and the output's
    cotangent g, in x's dtype -> ``(dx, [14 weight gradients])``, each
    gradient in its weight's shape and x's dtype. Adds one to
    ``fused_spatial_stack_cuda_bwd.launches`` per call (and, for bf16, to
    ``.bf16_launches``)."""
    hidden = check_stack(x, weights, num_heads)
    if g.shape != x.shape:
        raise ValueError(f"g must be {tuple(x.shape)}, got {tuple(g.shape)}")
    check_dtypes("the spatial backward", x, (g,))
    if any(t.dtype != torch.float32 for t in saved):
        raise TypeError("the spatial backward's saved residuals are float32")
    device = cuda_build.check_cuda_tensors(
        "fused_spatial_stack_cuda_bwd", dtypes=KERNEL_DTYPES, x=x, g=g,
        **{f"weights[{i}]": w for i, w in enumerate(weights)})
    N, J, E = x.shape
    depth = weights[0].shape[0]
    _, rows, frames = kernel_tiles(J, E, num_heads, hidden, x.element_size())
    _check_aligned((x, g, *weights))
    shapes = saved_shapes(depth, N * J, E, hidden)
    if len(saved) != len(shapes) or any(
            tuple(t.shape) != s for t, s in zip(saved, shapes)):
        raise ValueError(f"saved must be tensors of shapes {shapes}")
    cuda_build.check_cuda_tensors(
        "fused_spatial_stack_cuda_bwd",
        **dict(zip(SAVED, saved)))
    sizes = [w.numel() for w in weights]
    if N == 0:
        return torch.zeros_like(x), [torch.zeros_like(w) for w in weights]
    empty = functools.partial(torch.empty, dtype=torch.float32, device=device)
    bf16 = x.dtype == torch.bfloat16
    dx, flat = torch.empty_like(x), torch.empty(sum(sizes), dtype=x.dtype,
                                                device=device)
    # bf16: the running gradient stays float32 through the depth blocks
    work = (empty(x.shape),) if bf16 else ()
    lib = _library()
    with torch.cuda.device(device):
        grid = (lib.pv2c_spatial_stack_bwd_grid_bf16 if bf16
                else lib.pv2c_spatial_stack_bwd_grid)(
            J, E, num_heads, hidden, rows, frames)
        if grid < 1:
            cuda_build.check_launch(-grid, "pv2c_spatial_stack_bwd_grid")
        part = empty((grid, sum(sizes)))
        entry = lib.pv2c_fused_spatial_stack_bwd_bf16 if bf16 \
            else lib.pv2c_fused_spatial_stack_bwd
        err = entry(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(),
            *(t.data_ptr() for t in work),
            *(w.data_ptr() for w in weights), *(t.data_ptr() for t in saved),
            part.data_ptr(), flat.data_ptr(), N, J, E, num_heads, hidden,
            depth, grid, rows, frames, float(E // num_heads) ** -0.5,
            torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check_launch(err, "pv2c_fused_spatial_stack_bwd")
    fused_spatial_stack_cuda_bwd.launches += 1
    fused_spatial_stack_cuda_bwd.bf16_launches += bf16
    return dx, [t.view_as(w) for t, w in zip(flat.split(sizes), weights)]


cuda_build.counted("fused_spatial_stack_bwd", fused_spatial_stack_cuda_bwd,
                   bf16=True)


@torch.library.custom_op("pv2c::fused_spatial_stack", mutates_args=(),
                         device_types="cpu")
def fused_spatial_stack_op(x: torch.Tensor, weights: List[torch.Tensor],
                           num_heads: int) -> torch.Tensor:
    """Row 4's serving entry as a ``torch.library`` op (one node of an
    exported graph): ``fused_spatial_stack_cuda`` on the card, the plain
    version on the CPU."""
    check_stack(x, weights, num_heads)
    return spatial_stack_reference(x, weights, num_heads)


@fused_spatial_stack_op.register_kernel("cuda")
def _(x, weights, num_heads):
    return fused_spatial_stack_cuda(x, weights, num_heads)


@fused_spatial_stack_op.register_fake
def _(x, weights, num_heads):
    check_stack(x, weights, num_heads)
    return torch.empty_like(x)


class FusedSpatialStack(torch.autograd.Function):
    """Kernel forward and kernel backward (CUDA), or the plain forward and
    autograd of it (CPU), as the JAX package's custom VJP. ``keep``: a
    gradient will be asked for, so the kernel forward keeps the residuals
    the backward takes; without it the forward is
    ``pv2c::fused_spatial_stack``."""

    @staticmethod
    def forward(ctx, x, num_heads, keep, *weights):
        ctx.num_heads = num_heads
        if keep and x.device.type == "cuda":
            out, saved = fused_spatial_stack_cuda(x, weights, num_heads,
                                                  keep=True)
            ctx.save_for_backward(x, *weights, *saved)
            return out
        if keep:
            ctx.save_for_backward(x, *weights)
        return fused_spatial_stack_op(x, list(weights), num_heads)

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        weights, saved = rest[:14], rest[14:]
        if x.device.type == "cuda":
            dx, dws = fused_spatial_stack_cuda_bwd(
                x, weights, saved, g.contiguous(), ctx.num_heads)
        else:
            dx, dws = plain_backward(spatial_stack_reference, x, weights, g,
                                     ctx.num_heads)
        return (dx, None, None, *dws)


def fused_spatial_stack(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        num_heads: int) -> torch.Tensor:
    """depth x pre-norm block + final LayerNorm on (N, J, E) float32 or
    bf16 token rows, fused; ``weights`` as the module docstring says, in
    x's dtype. Differentiable in x and every weight."""
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *weights))
    return FusedSpatialStack.apply(x.contiguous(), num_heads, keep,
                                   *(w.contiguous() for w in weights))
