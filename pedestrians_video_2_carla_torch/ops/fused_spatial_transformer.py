"""PoseFormer's spatial transformer stack (depth pre-norm blocks and the
final LayerNorm over the J joint tokens of each frame) as CUDA kernels,
``csrc/fused_spatial_transformer.cu``: a forward and a hand-written
backward, with their plain PyTorch version and the autograd wrapper.

The forward replaces the TPU kernel ``_fwd_kernel`` of the JAX package's
``ops/pallas/fused_spatial_transformer.py`` (``fused_spatial_stack``). On an
H100 operations bound it: at B=256, L=16 it does 8.40 GFLOP (125 us at the
fp32 peak) against about 27 MB of traffic; its design (a few frames per
thread block, resident in shared memory through the whole stack) is
described in the source. The backward replaces ``_bwd_kernel``
(``_fused_bwd_impl``): dx and the 14 weight gradients, the forward
recomputed from x in the same launch (67.18 GFLOP at B=1024, L=16, a 1.00
ms bound), per-block partial weight gradients summed in a fixed order.

``fused_spatial_stack`` launches the kernels for CUDA tensors and runs the
plain version (and autograd of it) for CPU tensors; there is no fallback
from one to the other.

The weights are a 14-tuple: the 12 block weights of ``ops/transformer.py``
(``BLOCK_WEIGHTS``, nn.Linear layout) each stacked over depth, then the
final LayerNorm's scale and bias (E,).
"""
import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from . import cuda_build
from .cuda_build import INT as _INT, PTR as _PTR
from .transformer import (block_reference, check_block_weights, layer_norm,
                          plain_backward)

_SOURCE = cuda_build.CSRC / "fused_spatial_transformer.cu"
_SIGNATURES = {
    "pv2c_fused_spatial_stack":
        [_PTR] * 16 + [_INT] * 6 + [ctypes.c_float, _PTR],
    "pv2c_spatial_stack_smem_bytes": [_INT] * 4,
    "pv2c_fused_spatial_stack_bwd":
        [_PTR] * 20 + [_INT] * 7 + [ctypes.c_float, _PTR],
    "pv2c_spatial_stack_bwd_smem_bytes": [_INT] * 4,
    "pv2c_spatial_stack_bwd_grid": [_INT] * 5,
}

#: the kernel's compiled limits (csrc/fused_spatial_transformer.cu)
MAX_TOKENS = 32
MAX_HEAD_WIDTH = 16
#: shared memory a thread block may use on an H100 (sm_90)
MAX_SMEM_BYTES = 232448


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
    for t in (x, *weights):
        if t.dtype != torch.float32:
            raise TypeError(f"the spatial stack runs in float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"weights on {t.device}, x on {x.device}")
    return hidden


def spatial_stack_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                            num_heads: int) -> torch.Tensor:
    """The plain PyTorch version: (N, J, E) -> (N, J, E)."""
    *blocks, lnf_s, lnf_b = weights
    for d in range(blocks[0].shape[0]):
        x = block_reference(x, [w[d] for w in blocks], num_heads)
    return layer_norm(x, lnf_s, lnf_b)


def _check_limits(x, weights, num_heads, hidden, smem_bytes) -> None:
    """The kernels' compiled limits, alignment and shared memory
    (``smem_bytes``: the library's size function of the entry)."""
    J, E = x.shape[1:]
    if J > MAX_TOKENS or E // num_heads > MAX_HEAD_WIDTH or E % 4 \
            or hidden % 4:
        raise ValueError(
            f"the spatial kernel takes J <= {MAX_TOKENS}, head width <= "
            f"{MAX_HEAD_WIDTH} and widths that are multiples of 4; got J={J}, "
            f"E={E}, {num_heads} heads, hidden {hidden}")
    if any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("the spatial kernel needs 16-byte aligned tensors")
    smem = smem_bytes(J, E, num_heads, hidden)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"J={J}, E={E}, hidden {hidden} need {smem} bytes of "
                         f"shared memory per block, more than {MAX_SMEM_BYTES}")


def fused_spatial_stack_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                             num_heads: int) -> torch.Tensor:
    """Launch the kernel on float32 contiguous CUDA tensors: (N, J, E) ->
    (N, J, E). Adds one to ``fused_spatial_stack_cuda.launches`` per
    launch."""
    hidden = check_stack(x, weights, num_heads)
    device = cuda_build.check_cuda_tensors(
        "fused_spatial_stack_cuda", x=x,
        **{f"weights[{i}]": w for i, w in enumerate(weights)})
    N, J, E = x.shape
    depth = weights[0].shape[0]
    lib = _library()
    _check_limits(x, weights, num_heads, hidden,
                  lib.pv2c_spatial_stack_smem_bytes)
    out = torch.empty_like(x)
    if N == 0:
        return out
    with torch.cuda.device(device):
        err = lib.pv2c_fused_spatial_stack(
            x.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in weights),
            N, J, E, num_heads, hidden, depth, float(E // num_heads) ** -0.5,
            torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check_launch(err, "pv2c_fused_spatial_stack")
    fused_spatial_stack_cuda.launches += 1
    return out


fused_spatial_stack_cuda.launches = 0


def fused_spatial_stack_cuda_bwd(x: torch.Tensor,
                                 weights: Sequence[torch.Tensor],
                                 g: torch.Tensor, num_heads: int
                                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Launch the backward kernel on float32 contiguous CUDA tensors: the
    forward's input x (N, J, E), its weights and the output's cotangent g
    -> ``(dx, [14 weight gradients])``, each gradient in its weight's shape.
    Adds one to ``fused_spatial_stack_cuda_bwd.launches`` per launch."""
    hidden = check_stack(x, weights, num_heads)
    if g.shape != x.shape:
        raise ValueError(f"g must be {tuple(x.shape)}, got {tuple(g.shape)}")
    device = cuda_build.check_cuda_tensors(
        "fused_spatial_stack_cuda_bwd", x=x, g=g,
        **{f"weights[{i}]": w for i, w in enumerate(weights)})
    N, J, E = x.shape
    depth = weights[0].shape[0]
    lib = _library()
    _check_limits(x, (g, *weights), num_heads, hidden,
                  lib.pv2c_spatial_stack_bwd_smem_bytes)
    empty = functools.partial(torch.empty, dtype=torch.float32, device=device)
    sizes = [w.numel() for w in weights]
    if N == 0:
        return torch.zeros_like(x), [torch.zeros_like(w) for w in weights]
    dx, flat = torch.empty_like(x), empty(sum(sizes))
    with torch.cuda.device(device):
        grid = lib.pv2c_spatial_stack_bwd_grid(N, J, E, num_heads, hidden)
        if grid < 1:
            cuda_build.check_launch(-grid, "pv2c_spatial_stack_bwd_grid")
        xs, part = empty((depth, N, J, E)), empty((grid, sum(sizes)))
        err = lib.pv2c_fused_spatial_stack_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(),
            *(w.data_ptr() for w in weights), xs.data_ptr(), part.data_ptr(),
            flat.data_ptr(), N, J, E, num_heads, hidden, depth, grid,
            float(E // num_heads) ** -0.5,
            torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check_launch(err, "pv2c_fused_spatial_stack_bwd")
    fused_spatial_stack_cuda_bwd.launches += 1
    return dx, [t.view_as(w) for t, w in zip(flat.split(sizes), weights)]


fused_spatial_stack_cuda_bwd.launches = 0


class FusedSpatialStack(torch.autograd.Function):
    """Kernel forward and kernel backward (CUDA), or the plain forward and
    autograd of it (CPU), as the JAX package's custom VJP; only x and the
    weights are kept for the backward."""

    @staticmethod
    def forward(ctx, x, num_heads, *weights):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, *weights)
        if x.device.type == "cuda":
            return fused_spatial_stack_cuda(x, weights, num_heads)
        if x.device.type != "cpu":
            raise ValueError(f"fused_spatial_stack runs on cuda or cpu, not "
                             f"{x.device}")
        check_stack(x, weights, num_heads)
        return spatial_stack_reference(x, weights, num_heads)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        if x.device.type == "cuda":
            dx, dws = fused_spatial_stack_cuda_bwd(x, weights, g.contiguous(),
                                                   ctx.num_heads)
        else:
            dx, dws = plain_backward(spatial_stack_reference, x, weights, g,
                                     ctx.num_heads)
        return (dx, None, *dws)


def fused_spatial_stack(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        num_heads: int) -> torch.Tensor:
    """depth x pre-norm block + final LayerNorm on (N, J, E) float32 token
    rows, fused; ``weights`` as the module docstring says. Differentiable
    in x and every weight."""
    return FusedSpatialStack.apply(x.contiguous(), num_heads,
                                   *(w.contiguous() for w in weights))
