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

Both kernels take float32 or bf16 (x and the weights in one dtype). In
bf16, as the JAX kernels do with bf16 inputs: the forward rounds each
product's activation operand to bf16 and runs the product as one TF32
pass (exact on bf16 values, float32 sums), LayerNorm, attention, GELU and
the residual stream in float32, the output stored in bf16; the residuals
the training forward keeps stay float32; the backward runs in float32
and returns dx and the weight gradients (summed in float32) in bf16. The
kernels widen bf16 to float32 as they stage it, so their shared memory is
the same in both dtypes. ``spatial_stack_reference`` is the plain version
of either.
"""
import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from . import cuda_build
from .cuda_build import INT as _INT, PTR as _PTR
from .tensors import round_bf16
from .transformer import (KERNEL_DTYPES, block_reference,
                          check_block_weights, check_dtypes, layer_norm,
                          plain_backward)

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
_WPAD = 8


def _pad4(v: int) -> int:
    return (v + 3) & ~3


def _round8(v: int) -> int:
    return (v + 7) & ~7


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


def kernel_tiles(J: int, E: int, num_heads: int,
                 hidden: int) -> Tuple[int, int, int]:
    """The kernels' compiled limits; returns their tiles: (frames (warps)
    a thread block of the forward, rows a tile of the backward's MLP half,
    frames a tile of its attention half). Raises ValueError for a shape
    the kernels do not take."""
    if J > MAX_TOKENS or E > MAX_WIDTH or E // num_heads > MAX_HEAD_WIDTH \
            or E % 4 or hidden % 4:
        raise ValueError(
            f"the spatial kernel takes J <= {MAX_TOKENS}, E <= {MAX_WIDTH}, "
            f"head width <= {MAX_HEAD_WIDTH} and widths that are multiples "
            f"of 4; got J={J}, E={E}, {num_heads} heads, hidden {hidden}")
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
    frames, _, _ = kernel_tiles(J, E, num_heads, hidden)
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
    _, rows, frames = kernel_tiles(J, E, num_heads, hidden)
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
        grid = lib.pv2c_spatial_stack_bwd_grid(J, E, num_heads, hidden, rows,
                                               frames)
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
