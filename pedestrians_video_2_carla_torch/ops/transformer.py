"""The plain PyTorch pre-norm transformer block of PoseFormer (the JAX
package's flax ``_Block``): LayerNorm -> packed-qkv multi-head attention ->
proj -> residual -> LayerNorm -> fc1 -> exact GELU -> fc2 -> residual. The
spatial-stack and temporal-block kernels compute exactly this; it is their
plain version.

Weights are in PyTorch's ``nn.Linear`` layout, (out, in): the transpose of
flax's kernels, as the weight bridge (``models/jax_import.py``) gives them.
The qkv rows are in [q; k; v] x (head, dim) order.

``drop``, where given, is dropout at the flax block's positions (JAX
``models/movements/pose_former.py``): ``drop(t, "attn")`` on the attention
probabilities, ``drop(t, "out")`` after proj, after GELU and after fc2.
The kernels implement none; PoseFormer's plain route passes it.
``operand``, where given, maps each product's activation operand (LN1's
output, the attention output, LN2's output, GELU's output) before the
product: the bf16 plain versions of the kernels round them to bf16
(``ops/tensors.py::round_bf16``), as the kernels' bf16 forms do.
"""
from typing import Callable, Sequence

import torch
from torch.nn import functional as F

from .tensors import widen

#: torch's nn.LayerNorm default, which the JAX model uses as well
LN_EPS = 1e-5

#: one block's weights, in this order (D = width, HID = MLP hidden width):
#: ln1_s (D,), ln1_b (D,), qkv_w (3D, D), qkv_b (3D,), proj_w (D, D),
#: proj_b (D,), ln2_s (D,), ln2_b (D,), fc1_w (HID, D), fc1_b (HID,),
#: fc2_w (D, HID), fc2_b (D,)
Drop = Callable[[torch.Tensor, str], torch.Tensor]
Operand = Callable[[torch.Tensor], torch.Tensor]

BLOCK_WEIGHTS = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                 "ln2_s", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with flax's statistics: var =
    max(mean(x^2) - mean(x)^2, 0); the kernels use the same formula. A
    bf16 x follows flax's rule: statistics and normalisation in float32,
    the result in x's dtype."""
    dtype = x.dtype
    x = widen(x)
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dtype)


def no_dropout(t: torch.Tensor, kind: str) -> torch.Tensor:
    return t


def same(t: torch.Tensor) -> torch.Tensor:
    return t


def heads_attention(qkv: torch.Tensor, num_heads: int,
                    drop: Drop = no_dropout) -> torch.Tensor:
    """Multi-head self-attention from (N, T, 3D) ``qkv`` rows ([q | k | v],
    heads in (head, dim) order) -> (N, T, D), before the output
    projection, with q scaled by hd^-0.5 before the product, as the JAX
    model."""
    N, T, D3 = qkv.shape
    D = D3 // 3
    hd = D // num_heads
    q, k, v = qkv.reshape(N, T, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    probs = drop(torch.softmax((q * float(hd) ** -0.5) @ k.transpose(-2, -1),
                               dim=-1), "attn")
    return (probs @ v).transpose(1, 2).reshape(N, T, D)


def attention_heads(y: torch.Tensor, qkv_w, qkv_b, num_heads: int,
                    drop: Drop = no_dropout,
                    operand: Operand = same) -> torch.Tensor:
    """Multi-head self-attention over the tokens of (N, T, D) ``y`` before
    the output projection (:func:`heads_attention` of y's qkv)."""
    return heads_attention(F.linear(operand(y), qkv_w, qkv_b), num_heads,
                           drop)


def attention(y: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b,
              num_heads: int, drop: Drop = no_dropout,
              operand: Operand = same) -> torch.Tensor:
    """:func:`attention_heads`, then the output projection."""
    return F.linear(operand(attention_heads(y, qkv_w, qkv_b, num_heads, drop,
                                            operand)), proj_w, proj_b)


def block_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    num_heads: int, drop: Drop = no_dropout,
                    operand: Operand = same) -> torch.Tensor:
    """One pre-norm block on (N, T, D) ``x``; ``weights`` as
    :data:`BLOCK_WEIGHTS`."""
    (ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
     ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b) = weights
    x = x + drop(attention(layer_norm(x, ln1_s, ln1_b), qkv_w, qkv_b,
                           proj_w, proj_b, num_heads, drop, operand), "out")
    h = drop(F.gelu(F.linear(operand(layer_norm(x, ln2_s, ln2_b)), fc1_w,
                             fc1_b)), "out")
    return x + drop(F.linear(operand(h), fc2_w, fc2_b), "out")


def plain_backward(reference, x: torch.Tensor,
                   weights: Sequence[torch.Tensor], g: torch.Tensor,
                   num_heads: int):
    """Autograd of a kernel's plain version ``reference(x, weights,
    num_heads)`` with cotangent g: ``(dx, [weight grads])``, the backward
    of the kernel entries on CPU tensors."""
    leaves = [t.detach().requires_grad_(True) for t in (x, *weights)]
    with torch.enable_grad():
        out = reference(leaves[0], leaves[1:], num_heads)
        dx, *dws = torch.autograd.grad(out, leaves, g)
    return dx, dws


#: the dtypes of the kernels' storage: float32, and bf16 (its arithmetic in
#: float32, as the bf16 plain versions say)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_dtypes(what: str, x: torch.Tensor,
                 tensors: Sequence[torch.Tensor]) -> None:
    """x float32 or bf16 and every tensor of the call in x's dtype and on
    its device; raises TypeError / ValueError."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what} runs in float32 or bfloat16, got {x.dtype}")
    for t in tensors:
        if t.dtype != x.dtype:
            raise TypeError(f"{what} takes its weights in x's dtype "
                            f"{x.dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"weights on {t.device}, x on {x.device}")


def check_block_weights(weights: Sequence[torch.Tensor], dim: int,
                        stacked: bool = False) -> int:
    """Check one block's weights (``stacked``: a leading depth axis on
    each) against width ``dim``; returns the MLP hidden width."""
    if len(weights) != len(BLOCK_WEIGHTS):
        raise ValueError(f"expected {len(BLOCK_WEIGHTS)} block weights, got "
                         f"{len(weights)}")
    lead = tuple(weights[0].shape[:1]) if stacked else ()
    hidden = weights[8].shape[-2]
    shapes = ((dim,), (dim,), (3 * dim, dim), (3 * dim,), (dim, dim), (dim,),
              (dim,), (dim,), (hidden, dim), (hidden,), (dim, hidden), (dim,))
    for name, w, shape in zip(BLOCK_WEIGHTS, weights, shapes):
        if tuple(w.shape) != lead + shape:
            raise ValueError(f"{name} must be {lead + shape}, got "
                             f"{tuple(w.shape)}")
    return hidden
