"""Seq2Seq movements family (reference ``modules/movements/seq2seq/``): an
LSTM encoder, then an autoregressive LSTM decoder with teacher forcing, and
the Embeddings / FlatEmbeddings / ResidualA/B/C variants (the JAX
package's ``models/movements/seq2seq.py``).

The encoder's layers are :class:`~..rnn.HoistedLSTM`s that start from
zeros (no explicit carry), so ``rnn_kernel="fused"`` runs them through the
dense LSTM kernels on the card; the JAX encoder passes an explicit zero
carry, which keeps its scan, and both start from zeros. The decoder is a
plain per-frame loop of :class:`~..rnn.LSTMCell` stacks seeded by the
encoder's final (c, h) of each layer: no scan kernel applies to it. The
bidirectional encoder seeds the decoder with the mean of its two
directions' carries. Dropout and teacher-forcing masks come from the
``generator`` the flow passes when training, not from the JAX PRNG stream.
Parameter names follow the flax tree: ``OptimizedLSTMCell_{n}`` (encoder
layers, forward then reverse per layer), ``decoder.lstm_{layer}``,
``decoder.fc_out``, ``joint_embeddings`` / ``joint_embeddings_bias`` and
``Dense_{i}`` of the flat embeddings.
"""
import math
from enum import Enum
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...flows.output_types import MovementsModelOutputType
from ...ops.rotations import matrix_to_rotation_6d, mm, rotation_6d_to_matrix
from ..rnn import HoistedLSTM, LSTMCell
from .common import (MovementsModel, _uniform_, dropout, lecun_normal_,
                     torch_dense_init_)

RESIDUALS = ("none", "keep", "pure", "rot_mul")


class TeacherMode(Enum):
    no_force = 0
    clip_force = 1
    frames_force = 2


def _compose6(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, J * 6) 6D rotations a, b -> the 6D of ``R(a) @ R(b)``."""
    shape = a.shape
    mat = mm(rotation_6d_to_matrix(a.reshape(shape[0], -1, 6)),
             rotation_6d_to_matrix(b.reshape(shape[0], -1, 6)))
    return matrix_to_rotation_6d(mat).reshape(shape)


class _Decoder(nn.Module):
    """The decoder's parameters (``lstm_{layer}``, ``fc_out``) and one
    autoregressive step."""

    def __init__(self, output_size: int, hidden_size: int, num_layers: int,
                 p_dropout: float, residual: str,
                 generator: Optional[torch.Generator]) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.p_dropout = p_dropout
        self.residual = residual
        width = output_size
        for layer in range(num_layers):
            self.add_module(f"lstm_{layer}", LSTMCell(
                width, hidden_size, init="torch", generator=generator))
            width = hidden_size
        self.fc_out = nn.Linear(hidden_size, output_size)
        torch_dense_init_(self.fc_out, generator)

    def step(self, states, prev_inp, force_mask, force_target,
             training: bool, generator):
        """-> (new states, the next step's input, this step's output)."""
        h = prev_inp
        new_states = []
        for layer in range(self.num_layers):
            state, h = getattr(self, f"lstm_{layer}")(states[layer], h)
            new_states.append(state)
            if layer < self.num_layers - 1:
                # nn.LSTM(dropout=p): between stacked layers only
                h = dropout(h, self.p_dropout, training, generator)
        output = self.fc_out(h)

        if self.residual == "none":
            returned, next_inp = output, output
        elif self.residual == "keep":
            # ResidualA: the residual is kept in the returned output
            returned = next_inp = output + prev_inp
        elif self.residual == "pure":
            # ResidualB: the residual feeds the next step only
            returned, next_inp = output, output + prev_inp
        else:
            # ResidualC: rotations composed multiplicatively
            returned, next_inp = output, _compose6(prev_inp, output)

        if force_mask is not None:
            if self.residual in ("keep", "pure"):
                forced = force_target + prev_inp
            elif self.residual == "rot_mul":
                forced = _compose6(prev_inp, force_target)
            else:
                forced = force_target
            next_inp = torch.where(force_mask[:, None], forced, next_inp)
        return new_states, next_inp, returned


class Seq2Seq(MovementsModel):
    """LSTM encoder -> autoregressive LSTM decoder with teacher forcing.
    ``rnn_kernel`` ("auto" | "plain" | "fused") goes to the encoder's
    layers (``models/rnn.py``). ``residual`` is how the decoder's step
    output meets its previous input: "none", "keep" (ResidualA), "pure"
    (ResidualB) or "rot_mul" (ResidualC), each variant's own by default.
    ``unroll`` is the JAX package's scan unroll factor: the port's
    recurrences run one frame a step whatever it is."""

    def __init__(self, hidden_size: int = 64, num_layers: int = 2,
                 p_dropout: float = 0.2, teacher_mode: str = "no_force",
                 teacher_force_ratio: float = 0.2,
                 teacher_force_drop: float = 0.02,
                 invert_sequence: bool = False, bidirectional: bool = False,
                 residual: str = "none", unroll: int = 1,
                 rnn_kernel: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        TeacherMode[teacher_mode]  # an unknown mode raises here
        if residual not in RESIDUALS:
            raise ValueError(f"unknown residual {residual!r}; one of "
                             f"{RESIDUALS}")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.p_dropout = p_dropout
        self.teacher_mode = teacher_mode
        self.teacher_force_ratio = teacher_force_ratio
        self.teacher_force_drop = teacher_force_drop
        self.invert_sequence = invert_sequence
        self.bidirectional = bidirectional
        self.rnn_kernel = rnn_kernel
        self.residual = residual
        self.unroll = unroll
        self.output_size = len(self.output_nodes) * self.output_features
        if self.residual == "rot_mul" and self.output_size % 6:
            raise ValueError("ResidualC composes 6D rotations: its output "
                             "type must be pose_changes or relative_rot")
        width = self._build_embedding(generator)
        cell = 0
        for _ in range(num_layers):
            for reverse in ((False, True) if bidirectional else (False,)):
                self.add_module(f"OptimizedLSTMCell_{cell}", HoistedLSTM(
                    width, hidden_size, reverse=reverse, kernel=rnn_kernel,
                    init="torch", generator=generator))
                cell += 1
            width = hidden_size * (2 if bidirectional else 1)
        self.decoder = _Decoder(self.output_size, hidden_size, num_layers,
                                p_dropout, self.residual, generator)

    @property
    def needs_targets(self) -> bool:
        return TeacherMode[self.teacher_mode] != TeacherMode.no_force

    # -- input embedding (variants override) -------------------------------
    def _build_embedding(self, generator) -> int:
        """Build the embedding's parameters; -> the encoder's input width."""
        return len(self.input_nodes) * self.input_features

    def _format_input(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, J, C) -> (B, L, E)."""
        return x.reshape(x.shape[0], x.shape[1], -1)

    def _target_output(self, targets) -> Optional[torch.Tensor]:
        if targets is None:
            return None
        if self.movements_output_type \
                == MovementsModelOutputType.pose_changes \
                and targets.get("pose_changes") is not None:
            t = matrix_to_rotation_6d(targets["pose_changes"])
        elif targets.get("projection_2d_transformed") is not None:
            t = targets["projection_2d_transformed"]
        else:
            return None
        return t.reshape(t.shape[0], t.shape[1], -1)

    def _encode(self, inp, training, generator):
        """-> the decoder's initial (c, h) per layer."""
        h = inp
        states = []
        cell = 0
        for layer in range(self.num_layers):
            layer_in = h  # both directions read the same layer input
            carry, h = getattr(self, f"OptimizedLSTMCell_{cell}")(layer_in)
            cell += 1
            if self.bidirectional:
                carry_b, h_b = getattr(
                    self, f"OptimizedLSTMCell_{cell}")(layer_in)
                cell += 1
                # h_b is in processing order (last frame first): flip it to
                # input order, so that frame t joins the forward state
                # through t and the backward state from t
                h = torch.cat([h, h_b.flip(1)], dim=-1)
                # the decoder starts from the mean of the two directions
                carry = tuple((a + b) / 2 for a, b in zip(carry, carry_b))
            states.append(carry)
            if layer < self.num_layers - 1:
                h = dropout(h, self.p_dropout, training, generator)
        return states

    def _force_masks(self, targets, B, L, training, generator, device):
        """-> (per-frame (B,) masks and (B, E) targets, or Nones)."""
        mode = TeacherMode[self.teacher_mode]
        target_output = self._target_output(targets) if training else None
        if not (training and mode != TeacherMode.no_force
                and target_output is not None
                and self.teacher_force_ratio > 0):
            return [None] * L, [None] * L
        if generator is None:
            raise ValueError("teacher forcing in training needs a generator")
        if mode == TeacherMode.clip_force:
            draw = torch.rand((1, B), generator=generator, device=device)
            masks = (draw < self.teacher_force_ratio).expand(L, B)
        else:
            draw = torch.rand((L, B), generator=generator, device=device)
            masks = draw < self.teacher_force_ratio
        return list(masks), list(target_output.transpose(0, 1))

    def forward(self, x: torch.Tensor, targets=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B, L = x.shape[:2]
        inp = self._format_input(x)
        if self.invert_sequence:
            inp = inp.flip(1)
        states = self._encode(inp, training, generator)
        masks, forced = self._force_masks(targets, B, L, training, generator,
                                          x.device)
        if self.residual == "rot_mul":
            # the identity rotation's 6D: a zero start would be a degenerate
            # rotation whose Gram-Schmidt gradients overflow
            prev = x.new_tensor([1., 0., 0., 0., 1., 0.]).repeat(
                self.output_size // 6).expand(B, self.output_size)
        else:
            prev = x.new_zeros((B, self.output_size))
        outputs = []
        for t in range(L):
            states, prev, out = self.decoder.step(
                states, prev, masks[t], forced[t], training, generator)
            outputs.append(out)
        outputs = torch.stack(outputs, dim=1)
        return self.format_output(outputs.reshape(
            B, L, len(self.output_nodes), self.output_features))


class Seq2SeqEmbeddings(Seq2Seq):
    """Per-joint (2 -> E) embeddings, one grouped product over a (J, 2, E)
    weight; the encoder's first input is J E wide."""

    def __init__(self, *args, single_joint_embeddings_size: int = 64,
                 **kwargs) -> None:
        self.single_joint_embeddings_size = single_joint_embeddings_size
        super().__init__(*args, **kwargs)

    def _build_embedding(self, generator) -> int:
        J, E = len(self.input_nodes), self.single_joint_embeddings_size
        self.joint_embeddings = nn.Parameter(torch.empty(J, 2, E))
        self.joint_embeddings_bias = nn.Parameter(torch.empty(J, E))
        for p in (self.joint_embeddings, self.joint_embeddings_bias):
            _uniform_(p, 1.0 / math.sqrt(2.0), generator)
        return J * E

    def _format_input(self, x):
        emb = torch.einsum("bljc,jce->blje", x[..., :2],
                           self.joint_embeddings) + self.joint_embeddings_bias
        return emb.reshape(x.shape[0], x.shape[1], -1)


class Seq2SeqFlatEmbeddings(Seq2Seq):
    """An MLP embedding (ReLU after every layer) over the flattened joints;
    widths ``embeddings_size`` (default 128, 64), flax's Dense init."""

    def __init__(self, *args, embeddings_size: Sequence[int] = (128, 64),
                 **kwargs) -> None:
        self.embeddings_size = tuple(embeddings_size)
        super().__init__(*args, **kwargs)

    def _build_embedding(self, generator) -> int:
        width = len(self.input_nodes) * self.input_features
        for i, out in enumerate(self.embeddings_size):
            dense = nn.Linear(width, out)
            lecun_normal_(dense.weight, generator)
            nn.init.zeros_(dense.bias)
            self.add_module(f"Dense_{i}", dense)
            width = out
        return width

    def _format_input(self, x):
        B, L = x.shape[:2]
        h = x.reshape(B * L, -1)
        for i in range(len(self.embeddings_size)):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        return h.reshape(B, L, -1)


class Seq2SeqResidualA(Seq2SeqEmbeddings):
    def __init__(self, *args, residual: str = "keep", **kwargs) -> None:
        super().__init__(*args, residual=residual, **kwargs)


class Seq2SeqResidualB(Seq2SeqEmbeddings):
    def __init__(self, *args, residual: str = "pure", **kwargs) -> None:
        super().__init__(*args, residual=residual, **kwargs)


class Seq2SeqResidualC(Seq2SeqEmbeddings):
    def __init__(self, *args, residual: str = "rot_mul", **kwargs) -> None:
        super().__init__(*args, residual=residual, **kwargs)
