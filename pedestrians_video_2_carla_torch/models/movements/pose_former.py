"""PoseFormer (Zheng et al., ICCV'21): a spatial transformer over the joints
of each frame, then a temporal transformer over each window of
``receptive_frames`` frames, predicting the window centre's 3D pose
(reference ``modules/movements/pose_former/pose_former.py``).

As in the JAX package, the spatial stage runs once per distinct frame (B*L
sequences), and only then are the frame embeddings gathered into the
L - rf + 1 sliding windows, batch-major (n = b*W + w).

Each stage has a switch, ``spatial_kernel`` and ``temporal_kernel``, with
the JAX model's values under the port's names (``"auto" | "fused" |
"plain"`` for JAX's ``"auto" | "pallas" | "xla"``):
  * ``"plain"``: the blocks in plain PyTorch (``ops/transformer.py::
    block_reference``) on the CPU and on the card, with dropout at the flax
    blocks' positions (the attention probabilities at ``attn_drop_rate``;
    after proj, after GELU and after fc2 at ``drop_rate``);
  * ``"fused"``: the stage's CUDA kernels, forward and backward
    (``ops/fused_spatial_transformer.py``, ``ops/fused_temporal_
    transformer.py``); their plain versions and autograd of them for CPU
    tensors. It raises on a training step with block dropout (the kernels
    implement none) and on a shape the kernels' limits refuse
    (``kernel_tiles``, ``check_limits``);
  * ``"auto"`` (the default): the kernels on the card, unless the step
    trains with block dropout or the limits refuse the shape; then, and on
    the CPU, ``"plain"``. The choice is made from the limits before any
    launch.
An evaluation step with dropout rates set still runs the kernels: dropout
is then the identity. The two outer dropouts (after the spatial position
embedding, on the temporal window tokens) run on every route, as in the
JAX model. Masks come from the ``generator`` the flow passes when training;
they repeat from its seed but are not the JAX PRNG's draws.

Parameter names are those of the public PoseFormer checkpoint
(``Spatial_blocks.i.attn.qkv.weight``, ``blocks.i.mlp.fc1.bias``, ...);
``models/jax_import.py::import_pose_former`` maps a flax tree onto them.
``PoseFormerRot`` is the 6D-rotations variant.
"""
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ...flows.output_types import MovementsModelOutputType
from ...ops.fused_spatial_transformer import (fused_spatial_stack,
                                              kernel_tiles)
from ...ops.fused_temporal_transformer import (check_limits,
                                               fused_temporal_stack)
from ...ops.rotations import rotation_6d_to_matrix
from ...ops.transformer import LN_EPS, block_reference, layer_norm
from .common import (FixedOutputModel, dropout, lecun_normal_, normal_,
                     trunc_normal_)

#: the stages' routes: the JAX model's "auto" | "pallas" | "xla"
KERNELS = ("auto", "fused", "plain")
_JAX_NAMES = {"pallas": "fused", "xla": "plain"}


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


class _Attention(nn.Module):
    """Packed qkv projection (rows [q; k; v] x (head, dim)) and proj."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class _Block(nn.Module):
    """The parameters of one pre-norm block; the kernels or
    ``block_reference`` compute it."""

    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, hidden)

    def weights(self) -> Tuple[torch.Tensor, ...]:
        """In the order of ``ops/transformer.py::BLOCK_WEIGHTS``."""
        return (self.norm1.weight, self.norm1.bias,
                self.attn.qkv.weight, self.attn.qkv.bias,
                self.attn.proj.weight, self.attn.proj.bias,
                self.norm2.weight, self.norm2.bias,
                self.mlp.fc1.weight, self.mlp.fc1.bias,
                self.mlp.fc2.weight, self.mlp.fc2.bias)


class PoseFormer(FixedOutputModel):
    """Predicts absolute joint locations (B, L, J, 3); the first and last
    ``receptive_frames // 2`` frames, which no window centres on, stay
    zeros and ``eval_slice`` leaves them out. ``clip_length`` only sets
    ``eval_slice``, as in the JAX model. ``remat`` is the JAX package's
    rematerialisation of the transformer blocks under the gradient: the
    port keeps the activations whatever it is."""
    OUTPUT_TYPE = MovementsModelOutputType.absolute_loc

    def __init__(self, clip_length: int = 30, receptive_frames: int = 9,
                 single_joint_embeddings_size: int = 32, depth: int = 4,
                 num_heads: int = 8, mlp_ratio: float = 2.0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 remat: bool = False,
                 spatial_kernel: str = "auto", temporal_kernel: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        for name, kernel in (("spatial_kernel", spatial_kernel),
                             ("temporal_kernel", temporal_kernel)):
            if kernel in _JAX_NAMES:
                raise ValueError(
                    f"{name} {kernel!r} is the JAX package's name; the "
                    f"port's is {_JAX_NAMES[kernel]!r}")
            if kernel not in KERNELS:
                raise ValueError(f"unknown {name} {kernel!r}; one of "
                                 f"{KERNELS}")
        super().__init__(**kwargs)
        self.clip_length = clip_length
        self.receptive_frames = receptive_frames
        self.num_heads = num_heads
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate
        self.remat = remat
        self.spatial_kernel = spatial_kernel
        self.temporal_kernel = temporal_kernel
        joints = len(self.input_nodes)
        emb = single_joint_embeddings_size
        dim = joints * emb
        self.Spatial_patch_to_embedding = nn.Linear(2, emb)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, joints, emb))
        self.Spatial_blocks = nn.ModuleList(
            _Block(emb, int(emb * mlp_ratio)) for _ in range(depth))
        self.Spatial_norm = nn.LayerNorm(emb, eps=LN_EPS)
        self.Temporal_pos_embed = nn.Parameter(
            torch.zeros(1, receptive_frames, dim))
        self.blocks = nn.ModuleList(
            _Block(dim, int(dim * mlp_ratio)) for _ in range(depth))
        self.Temporal_norm = nn.LayerNorm(dim, eps=LN_EPS)
        # the reference's Conv1d(rf, 1, 1): weight (1, rf, 1), bias (1,)
        self.weighted_mean = nn.Conv1d(receptive_frames, 1, 1)
        self.head = nn.Sequential(
            nn.LayerNorm(dim, eps=LN_EPS),
            nn.Linear(dim, joints * self.output_features))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Seeded init in the flax model's families: Dense kernels
        lecun-normal and biases zero, position embeddings truncated
        N(0, 0.02), the weighted mean N(0, 0.02) with a zero bias,
        LayerNorms ones and zeros."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                lecun_normal_(module.weight, generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
        trunc_normal_(self.Spatial_pos_embed, 0.02, generator)
        trunc_normal_(self.Temporal_pos_embed, 0.02, generator)
        normal_(self.weighted_mean.weight, 0.02, generator)
        nn.init.zeros_(self.weighted_mean.bias)

    @property
    def eval_slice(self):
        shift = self.receptive_frames // 2
        return slice(shift, self.clip_length - self.receptive_frames
                     + shift + 1)

    def spatial_weights(self) -> List[torch.Tensor]:
        """The 14 weights of ``fused_spatial_stack``: each block weight
        stacked over depth, then the final LayerNorm."""
        per_block = [b.weights() for b in self.Spatial_blocks]
        return [torch.stack(ws) for ws in zip(*per_block)] + [
            self.Spatial_norm.weight, self.Spatial_norm.bias]

    def temporal_weights(self) -> List[Tuple[torch.Tensor, ...]]:
        return [b.weights() for b in self.blocks]

    def _takes_kernels(self, stage: str, kernel: str, on_card: bool,
                       block_dropout: bool,
                       limits: Callable[[], object]) -> bool:
        """Whether ``stage`` runs its kernels: ``"fused"`` always (raising
        on block dropout in training, and through ``limits`` on a shape the
        kernels refuse), ``"auto"`` on the card where neither holds."""
        if kernel == "plain":
            return False
        if kernel == "fused":
            if block_dropout:
                raise ValueError(
                    f"{stage}_kernel='fused' implements no dropout inside "
                    f"the fused blocks; train with drop_rate=0/"
                    f"attn_drop_rate=0 or {stage}_kernel='plain'/'auto'")
            limits()
            return True
        if not on_card or block_dropout:
            return False
        try:
            limits()    # the kernels' limits, computed without a launch
        except ValueError:
            return False
        return True

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L, J, _ = x.shape
        rf = self.receptive_frames
        W = L - rf + 1
        if W < 1:
            raise ValueError(f"clips of {L} frames are shorter than the "
                             f"receptive field ({rf} frames)")
        emb = self.Spatial_pos_embed.shape[-1]
        dim = J * emb
        on_card = _on_card(x)
        block_dropout = training and (self.drop_rate > 0
                                      or self.attn_drop_rate > 0)

        def drop(t, kind="out"):
            rate = self.attn_drop_rate if kind == "attn" else self.drop_rate
            return dropout(t, rate, training, generator)

        # spatial stage: joints as tokens, once per distinct frame
        s = drop(self.Spatial_patch_to_embedding(x[..., :2])
                 + self.Spatial_pos_embed).reshape(B * L, J, emb)
        hidden = self.Spatial_blocks[0].mlp.fc1.out_features
        if self._takes_kernels(
                "spatial", self.spatial_kernel, on_card, block_dropout,
                lambda: kernel_tiles(J, emb, self.num_heads, hidden)):
            s = fused_spatial_stack(s, self.spatial_weights(),
                                    self.num_heads)
        else:
            for block in self.Spatial_blocks:
                s = block_reference(s, block.weights(), self.num_heads, drop)
            s = layer_norm(s, self.Spatial_norm.weight, self.Spatial_norm.bias)

        # temporal stage: the frames of each window as tokens
        windows = s.reshape(B, L, dim).unfold(1, rf, 1)  # (B, W, D, rf)
        t = drop(windows.transpose(2, 3) + self.Temporal_pos_embed
                 ).reshape(B * W, rf, dim)
        hidden = self.blocks[0].mlp.fc1.out_features
        if self._takes_kernels(
                "temporal", self.temporal_kernel, on_card, block_dropout,
                lambda: check_limits(rf, dim, self.num_heads, hidden)):
            t = fused_temporal_stack(t, self.temporal_weights(),
                                     self.num_heads)
        else:
            for block in self.blocks:
                t = block_reference(t, block.weights(), self.num_heads, drop)
        t = layer_norm(t, self.Temporal_norm.weight, self.Temporal_norm.bias)
        pooled = torch.einsum("nfd,f->nd", t,
                              self.weighted_mean.weight.reshape(rf)) \
            + self.weighted_mean.bias
        norm, linear = self.head
        out = F.linear(layer_norm(pooled, norm.weight, norm.bias),
                       linear.weight, linear.bias)

        # window centres to their frames; the edge frames stay zeros
        shift = rf // 2
        full = out.new_zeros((B, L, J, self.output_features))
        full[:, shift:shift + W] = out.reshape(B, W, J, self.output_features)
        return self._finalize(full)

    def _finalize(self, out: torch.Tensor):
        return out


class PoseFormerRot(PoseFormer):
    """PoseFormer predicting relative joint rotations: 6 features per joint
    -> (B, L, J, 3, 3) rotation matrices."""
    OUTPUT_TYPE = MovementsModelOutputType.relative_rot

    def _finalize(self, out: torch.Tensor):
        return rotation_6d_to_matrix(out)
