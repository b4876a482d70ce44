"""Analytic FLOP counts of the transformer kernels: the port's own copy of
what it needs of the JAX package's ``ops/pallas/flops.py`` (the port
imports nothing of that package), and the backward's count; the FLOP
and byte counts of the graph-GRU and graph-LSTM scans; and the dense
products of VideoPose3D (BASELINE config 4). ``chip_smoke.py`` bounds the
kernels, forward and backward, and config 4's step with them.

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


def transformer_block_backward_flops(n_tokens: int, dim: int,
                                     mlp_ratio: float = 2.0,
                                     seq_len: Optional[int] = None) -> int:
    """Matmul FLOPs of ONE block's backward pass, dx and dW: each dense
    projection twice (dX = dY W and dW = dY^T X), (16 + 8r) * D^2 FLOPs per
    token; and, when ``seq_len`` is given, four attention products (dP =
    dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q) against the forward's two,
    8 * seq_len * D FLOPs per token."""
    flops_per_token = 2 * (8 + 4 * mlp_ratio) * dim * dim
    if seq_len is not None:
        flops_per_token += 8 * seq_len * dim
    return int(n_tokens * flops_per_token)


def poseformer_kernel_train_flops(batch: int, clip_length: int = 16,
                                  receptive_frames: int = 9, joints: int = 26,
                                  embed_dim: int = 32, depth: int = 4,
                                  mlp_ratio: float = 2.0,
                                  include_attention: bool = False) -> int:
    """Analytic matmul FLOPs of the spatial + temporal kernels in one
    PoseFormer TRAIN step (fwd + dx + dW ~ 3x the forward).

    The spatial stage runs ``depth`` blocks over ``batch * L`` windows of
    ``joints`` tokens at ``embed_dim``; the temporal stage runs ``depth``
    blocks over ``batch * (L - rf + 1)`` windows of ``receptive_frames``
    tokens at ``joints * embed_dim`` (models/movements/pose_former.py).
    Attention score/value FLOPs are excluded by default, so the count is a
    lower bound.
    """
    seq_s = joints if include_attention else None
    seq_t = receptive_frames if include_attention else None
    fwd = depth * (
        transformer_block_matmul_flops(
            batch * clip_length * joints, embed_dim, mlp_ratio, seq_s)
        + transformer_block_matmul_flops(
            batch * (clip_length - receptive_frames + 1) * receptive_frames,
            joints * embed_dim, mlp_ratio, seq_t))
    return int(3 * fwd)


#: gates of a graph scan's cell, and gates per hidden-side product
SCAN_GATES = {"gru": 3, "lstm": 4}


def graph_scan_flops(cell: str, batch: int, clip_length: int, joints: int,
                     hidden: int, k: int, backward: bool = False) -> int:
    """FLOPs of one graph-GRU or graph-LSTM scan (``ops/fused_graph_gru
    .py``), forward or backward, counting the cheaper order of the
    hidden-side convolution (the graph applied to the H-wide operand, then
    one product).

    Forward, per row (a joint of a clip in a frame): the hidden products,
    2 k H G H; the graph applied to the carry, 2 (k - 1) J H, once for the
    LSTM and twice for the GRU (h and r h). Backward: dh through da W^T
    (the hidden products' count) and the transposed graph (the graph's
    count), and the weight gradients over all rows (the hidden products'
    count again). Every backward reads the gates its training forward kept
    and recomputes none of them. Elementwise gating is left out."""
    gates = SCAN_GATES[cell]
    rows = batch * clip_length * joints
    products = 2 * k * hidden * gates * hidden
    graph = 2 * (k - 1) * joints * hidden * (2 if cell == "gru" else 1)
    per_row = 2 * products + graph if backward else products + graph
    return int(rows * per_row)


def graph_scan_bytes(cell: str, batch: int, clip_length: int, joints: int,
                     hidden: int, k: int, backward: bool = False,
                     with_dcs: bool = False, keep: bool = False,
                     dense: bool = False, element_size: int = 4) -> int:
    """Bytes a graph scan must move: each input read once and each output
    written once, at ``element_size`` bytes an element (4: float32; 2: the
    bf16 kernels) but the training forward's residuals (the gates and the
    expanded operands), float32 in both. Forward: xg in, ys (and the
    LSTM's cs) out, the weights and graph matrices in; the training forward
    (``keep``) also writes its residuals: the GRU's gates (3H a row) and
    both expanded operands (k H a row each), the graph-form LSTM's
    activated gates (4H a row) and expanded operand (k H), the ``dense``
    route's (k = 1) gates alone. Backward: dys (dcs where the caller used
    cs) and the weights in, dxg and the weight gradients out; the GRU reads
    its residuals, the LSTM its gates (4H), cs and the expanded operand
    (the dense route: ys in its place, H a row)."""
    gates = SCAN_GATES[cell]
    H = hidden
    rows = batch * clip_length * joints
    weights = k * H * gates * H + (k - 1) * joints * joints
    if backward and cell == "gru":
        kept = rows * (3 * H + 2 * k * H)
        stored = rows * (H + 3 * H) + 2 * weights
    elif backward:
        kept = rows * (gates * H + (0 if dense else k * H))
        stored = rows * (gates * H + H * (2 + (1 if with_dcs else 0))
                         + (H if dense else 0)) + 2 * weights
    else:
        states = 2 if cell == "lstm" else 1
        stored = rows * (gates * H + states * H) + weights
        kept = 0
        if keep and cell == "gru":
            kept = rows * (3 * H + 2 * k * H)
        elif keep:
            kept = rows * (gates * H + (0 if dense else k * H))
    return int(4 * kept + element_size * stored)


def video_pose_3d_flops(batch: int, clip_length: int, joints: int = 26,
                        filter_widths=(3, 3, 3, 3), channels: int = 1024,
                        train: bool = False) -> int:
    """FLOPs of VideoPose3D's dense products (``models/movements/
    video_pose_3d.py``), a forward or (``train``) a training step.

    The input (2 J features a frame) is edge-padded to L + rf - 1 frames.
    Each VALID conv of width w and dilation d over L_in frames gives
    L_in - d (w - 1) frames at 2 w C_in C_out FLOPs a frame: the expand
    conv (C_in = 2 J), then per residual block a width-w conv and a 1 x 1
    conv (C x C); the ``shrink`` head is 2 C 3 J a frame over L frames. A
    training step adds each product's weight gradient and its input
    gradient, all but the expand conv's (its input needs none).
    BatchNorm, ReLU and dropout are left out."""
    rf = 1
    for w in filter_widths:
        rf *= w
    frames = clip_length + rf - 1
    expand = 0
    forward = 0
    dilation, c_in = 1, 2 * joints
    for i, w in enumerate(filter_widths):
        frames -= dilation * (w - 1)
        conv = 2 * batch * frames * w * c_in * channels
        if i == 0:
            expand = conv
        else:
            conv += 2 * batch * frames * channels * channels   # the 1 x 1
        forward += conv
        dilation *= w
        c_in = channels
    forward += 2 * batch * clip_length * channels * 3 * joints
    return int(3 * forward - expand if train else forward)
