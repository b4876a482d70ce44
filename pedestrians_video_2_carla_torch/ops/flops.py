"""Analytic FLOP counts of the transformer kernels: the port's own copy of
what it needs of the JAX package's ``ops/pallas/flops.py`` (the port
imports nothing of that package). ``chip_smoke.py`` bounds the
spatial-stack and temporal-block kernels with them.

FLOP convention: 1 multiply-accumulate = 2 FLOPs.
"""
from typing import Optional


def transformer_block_matmul_flops(n_tokens: int, dim: int,
                                   mlp_ratio: float = 2.0,
                                   seq_len: Optional[int] = None) -> int:
    """Matmul FLOPs of ONE pre-norm transformer encoder block forward pass.

    Counts the dense projections: qkv 3*D^2 MACs, attn out D^2, fc1 r*D^2,
    fc2 r*D^2 per token -> (4 + 2r) * D^2 MACs = (8 + 4r) * D^2 FLOPs per
    token; plus the attention score (QK^T) and value (AV) matmuls --
    2 * seq_len * D MACs = 4 * seq_len * D FLOPs per token -- when
    ``seq_len`` is given.
    """
    flops_per_token = (8 + 4 * mlp_ratio) * dim * dim
    if seq_len is not None:
        flops_per_token += 4 * seq_len * dim
    return int(n_tokens * flops_per_token)

