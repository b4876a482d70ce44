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
"""
from typing import Callable, Sequence

import torch
from torch.nn import functional as F

#: torch's nn.LayerNorm default, which the JAX model uses as well
LN_EPS = 1e-5

#: one block's weights, in this order (D = width, HID = MLP hidden width):
#: ln1_s (D,), ln1_b (D,), qkv_w (3D, D), qkv_b (3D,), proj_w (D, D),
#: proj_b (D,), ln2_s (D,), ln2_b (D,), fc1_w (HID, D), fc1_b (HID,),
#: fc2_w (D, HID), fc2_b (D,)
Drop = Callable[[torch.Tensor, str], torch.Tensor]

BLOCK_WEIGHTS = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                 "ln2_s", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with flax's statistics: var =
    max(mean(x^2) - mean(x)^2, 0); the kernels use the same formula."""
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def no_dropout(t: torch.Tensor, kind: str) -> torch.Tensor:
    return t


def attention_heads(y: torch.Tensor, qkv_w, qkv_b, num_heads: int,
                    drop: Drop = no_dropout) -> torch.Tensor:
    """Multi-head self-attention over the tokens of (N, T, D) ``y`` before
    the output projection, with q scaled by hd^-0.5 before the product, as
    the JAX model."""
    N, T, D = y.shape
    hd = D // num_heads
    qkv = F.linear(y, qkv_w, qkv_b).reshape(N, T, 3, num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)            # each (N, H, T, hd)
    probs = drop(torch.softmax((q * float(hd) ** -0.5) @ k.transpose(-2, -1),
                               dim=-1), "attn")
    return (probs @ v).transpose(1, 2).reshape(N, T, D)


def attention(y: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b,
              num_heads: int, drop: Drop = no_dropout) -> torch.Tensor:
    """:func:`attention_heads`, then the output projection."""
    return F.linear(attention_heads(y, qkv_w, qkv_b, num_heads, drop),
                    proj_w, proj_b)


def block_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    num_heads: int, drop: Drop = no_dropout) -> torch.Tensor:
    """One pre-norm block on (N, T, D) ``x``; ``weights`` as
    :data:`BLOCK_WEIGHTS`."""
    (ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
     ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b) = weights
    x = x + drop(attention(layer_norm(x, ln1_s, ln1_b), qkv_w, qkv_b,
                           proj_w, proj_b, num_heads, drop), "out")
    h = drop(F.gelu(F.linear(layer_norm(x, ln2_s, ln2_b), fc1_w, fc1_b)),
             "out")
    return x + drop(F.linear(h, fc2_w, fc2_b), "out")


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
