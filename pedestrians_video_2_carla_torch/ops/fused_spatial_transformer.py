"""PoseFormer's spatial transformer stack (depth pre-norm blocks and the
final LayerNorm over the J joint tokens of each frame) as one CUDA kernel,
``csrc/fused_spatial_transformer.cu``, with its plain PyTorch version and
its autograd wrapper.

The kernel replaces the TPU kernel ``_fwd_kernel`` of the JAX package's
``ops/pallas/fused_spatial_transformer.py`` (``fused_spatial_stack``). On an
H100 operations bound it: at B=256, L=16 it does 8.40 GFLOP (125 us at the
fp32 peak) against about 27 MB of traffic; its design (a few frames per
thread block, resident in shared memory through the whole stack) is
described in the source.

``fused_spatial_stack`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no fallback from one to the other.
Its backward is not ported yet (the PoseFormer training slice, see
``ROADMAP.md``) and raises.

The weights are a 14-tuple: the 12 block weights of ``ops/transformer.py``
(``BLOCK_WEIGHTS``, nn.Linear layout) each stacked over depth, then the
final LayerNorm's scale and bias (E,).
"""
import ctypes
from typing import Sequence

import torch

from . import cuda_build
from .cuda_build import INT as _INT, PTR as _PTR
from .transformer import block_reference, check_block_weights, layer_norm

_SOURCE = cuda_build.CSRC / "fused_spatial_transformer.cu"
_SIGNATURES = {
    "pv2c_fused_spatial_stack":
        [_PTR] * 16 + [_INT] * 6 + [ctypes.c_float, _PTR],
    "pv2c_spatial_stack_smem_bytes": [_INT] * 4,
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
    hd = E // num_heads
    if J > MAX_TOKENS or hd > MAX_HEAD_WIDTH or E % 4 or hidden % 4:
        raise ValueError(
            f"the spatial kernel takes J <= {MAX_TOKENS}, head width <= "
            f"{MAX_HEAD_WIDTH} and widths that are multiples of 4; got J={J}, "
            f"E={E}, {num_heads} heads, hidden {hidden}")
    if any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("the spatial kernel needs 16-byte aligned tensors")
    lib = _library()
    smem = lib.pv2c_spatial_stack_smem_bytes(J, E, num_heads, hidden)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"J={J}, E={E}, hidden {hidden} need {smem} bytes of "
                         f"shared memory per block, more than {MAX_SMEM_BYTES}")
    out = torch.empty_like(x)
    if N == 0:
        return out
    with torch.cuda.device(device):
        err = lib.pv2c_fused_spatial_stack(
            x.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in weights),
            N, J, E, num_heads, hidden, depth, float(hd) ** -0.5,
            torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check_launch(err, "pv2c_fused_spatial_stack")
    fused_spatial_stack_cuda.launches += 1
    return out


fused_spatial_stack_cuda.launches = 0


class FusedSpatialStack(torch.autograd.Function):
    """Kernel forward (CUDA) or plain forward (CPU). No backward yet."""

    @staticmethod
    def forward(ctx, x, num_heads, *weights):
        if x.device.type == "cuda":
            return fused_spatial_stack_cuda(x, weights, num_heads)
        if x.device.type != "cpu":
            raise ValueError(f"fused_spatial_stack runs on cuda or cpu, not "
                             f"{x.device}")
        check_stack(x, weights, num_heads)
        return spatial_stack_reference(x, weights, num_heads)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the spatial stack's backward kernel is not ported yet "
            "(PoseFormer training, see ROADMAP.md)")


def fused_spatial_stack(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        num_heads: int) -> torch.Tensor:
    """depth x pre-norm block + final LayerNorm on (N, J, E) float32 token
    rows, fused; ``weights`` as the module docstring says."""
    return FusedSpatialStack.apply(x.contiguous(), num_heads,
                                   *(w.contiguous() for w in weights))
