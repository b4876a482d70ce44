"""One transformer block of PoseFormer's temporal stage (rf window tokens of
frame_dim = J x emb features) as a CUDA entry, ``csrc/
fused_temporal_transformer.cu``, with its plain PyTorch version and its
autograd wrapper, and the token-major entries ``fused_temporal_block`` and
``fused_temporal_stack``.

The entry replaces the TPU kernels ``_fwd_kernel_tl`` (the default
token-leading layout) and ``_fwd_kernel`` (the legacy padded layout) of the
JAX package's ``ops/pallas/fused_temporal_transformer.py``: one function in
two TPU layouts, one counterpart here. On an H100 operations bound it: at
B=256, L=16 a block does 204.7 GFLOP (3.06 ms at the fp32 peak) against
145 MB of traffic. It is a fixed sequence of seven launches (row
statistics, four GEMMs with fused LayerNorm / GELU / residual, attention),
described in the source; ``fused_temporal_block_cuda.launches`` counts entry
calls, one per transformer block.

The wrappers launch the kernels for CUDA tensors and run the plain version
for CPU tensors; there is no fallback from one to the other. The backward
is not ported yet (the PoseFormer training slice, see ``ROADMAP.md``) and
raises.

The weights of a block are the 12-tuple ``BLOCK_WEIGHTS`` of
``ops/transformer.py`` in nn.Linear layout, qkv rows in [q; k; v] x (head,
dim) order.
"""
import ctypes
import functools
from typing import Sequence

import torch

from . import cuda_build
from .cuda_build import INT as _INT, PTR as _PTR
from .transformer import block_reference, check_block_weights

_SOURCE = cuda_build.CSRC / "fused_temporal_transformer.cu"
_SIGNATURES = {
    "pv2c_fused_temporal_block":
        [_PTR] * 19 + [_INT] * 5 + [ctypes.c_float, _PTR],
}

#: the kernels' compiled limits (csrc/fused_temporal_transformer.cu)
MAX_TOKENS = 16
MAX_HEAD_WIDTH = 128


def check_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                num_heads: int) -> int:
    """Shapes and types of a block call; returns its MLP hidden width."""
    if x.ndim != 3:
        raise ValueError(f"x must be (N, T, D), got {tuple(x.shape)}")
    D = x.shape[-1]
    hidden = check_block_weights(weights, D)
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"{num_heads} heads do not divide width {D}")
    for t in (x, *weights):
        if t.dtype != torch.float32:
            raise TypeError(f"the temporal block runs in float32, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"weights on {t.device}, x on {x.device}")
    return hidden


def temporal_block_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                             num_heads: int) -> torch.Tensor:
    """The plain PyTorch version: (N, T, D) -> (N, T, D)."""
    return block_reference(x, weights, num_heads)


def fused_temporal_block_cuda(x: torch.Tensor,
                              weights: Sequence[torch.Tensor],
                              num_heads: int) -> torch.Tensor:
    """Launch the block on float32 contiguous CUDA tensors: (N, T, D) ->
    (N, T, D). Adds one to ``fused_temporal_block_cuda.launches`` per
    call."""
    hidden = check_block(x, weights, num_heads)
    device = cuda_build.check_cuda_tensors(
        "fused_temporal_block_cuda", x=x,
        **{f"weights[{i}]": w for i, w in enumerate(weights)})
    N, T, D = x.shape
    hd = D // num_heads
    if T > MAX_TOKENS or hd > MAX_HEAD_WIDTH or D % 8 or hidden % 8:
        raise ValueError(
            f"the temporal kernel takes T <= {MAX_TOKENS}, head width <= "
            f"{MAX_HEAD_WIDTH} and widths that are multiples of 8; got T={T}, "
            f"D={D}, {num_heads} heads, hidden {hidden}")
    if any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("the temporal kernel needs 16-byte aligned tensors")
    out = torch.empty_like(x)
    M = N * T
    if M == 0:
        return out
    empty = functools.partial(torch.empty, dtype=torch.float32, device=device)
    scratch = (empty(4 * M), empty((M, 3 * D)), empty((M, D)), empty((M, D)),
               empty((M, hidden)))
    lib = cuda_build.load_library(_SOURCE, _SIGNATURES)
    with torch.cuda.device(device):
        err = lib.pv2c_fused_temporal_block(
            x.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in weights),
            *(s.data_ptr() for s in scratch), N, T, D, num_heads, hidden,
            float(hd) ** -0.5, torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check_launch(err, "pv2c_fused_temporal_block")
    fused_temporal_block_cuda.launches += 1
    return out


fused_temporal_block_cuda.launches = 0


class FusedTemporalBlock(torch.autograd.Function):
    """Kernel forward (CUDA) or plain forward (CPU). No backward yet."""

    @staticmethod
    def forward(ctx, x, num_heads, *weights):
        if x.device.type == "cuda":
            return fused_temporal_block_cuda(x, weights, num_heads)
        if x.device.type != "cpu":
            raise ValueError(f"fused_temporal_block runs on cuda or cpu, not "
                             f"{x.device}")
        check_block(x, weights, num_heads)
        return temporal_block_reference(x, weights, num_heads)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the temporal block's backward kernel is not ported yet "
            "(PoseFormer training, see ROADMAP.md)")


def fused_temporal_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         num_heads: int) -> torch.Tensor:
    """One pre-norm transformer block on (N, T, D) float32 window tokens,
    fused; ``weights`` as the module docstring says."""
    return FusedTemporalBlock.apply(x.contiguous(), num_heads,
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
