"""Shared movements-model base: an ``nn.Module`` carrying skeleton and
output-type config, plus the seeded layer inits and dropout from an
explicit generator."""
import math
from typing import Callable, Optional, Type

import numpy as np
import torch
from torch import nn

from ...flows.output_types import MovementsModelOutputType
from ...skeletons.base import Skeleton
from ...skeletons.carla import CARLA_SKELETON
from ...ops.tensors import widen
from ..base import format_movements_output, movements_output_features


def _uniform_(tensor: torch.Tensor, bound: float,
              generator: Optional[torch.Generator]) -> None:
    """Fill ``tensor`` with U(-bound, bound) drawn from ``generator`` (on the
    generator's device), whatever device the tensor is on."""
    _fill_(tensor, lambda t: t.uniform_(-bound, bound, generator=generator),
           generator)


def _fill_(tensor: torch.Tensor, draw_: Callable[[torch.Tensor], None],
           generator: Optional[torch.Generator]) -> None:
    """Fill ``tensor`` with ``draw_`` applied on the generator's device."""
    device = generator.device if generator is not None else tensor.device
    draw = torch.empty(tensor.shape, dtype=tensor.dtype, device=device)
    draw_(draw)
    with torch.no_grad():
        tensor.copy_(draw)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (on x's
    device); the identity when not training or p = 0."""
    if not training or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


def trunc_normal_(tensor: torch.Tensor, std: float,
                  generator: Optional[torch.Generator] = None) -> None:
    """N(0, std^2) truncated at +-2 std, as flax's ``truncated_normal``
    draws it (without its variance correction)."""
    _fill_(tensor, lambda t: nn.init.trunc_normal_(
        t, std=std, a=-2 * std, b=2 * std, generator=generator), generator)


def lecun_normal_(tensor: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's default Dense kernel init: a truncated normal of variance
    1 / fan_in (the second axis of an nn.Linear weight)."""
    # 0.8796... is the std of a unit normal truncated at +-2
    trunc_normal_(tensor, math.sqrt(1.0 / tensor.shape[1]) / .87962566103423978,
                  generator)


def kaiming_normal_(tensor: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> None:
    """flax's ``nn.initializers.kaiming_normal()``: variance scaling 2.0 on
    fan_in (the second axis of an nn.Linear weight), a truncated normal."""
    trunc_normal_(tensor,
                  math.sqrt(2.0 / tensor.shape[1]) / .87962566103423978,
                  generator)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the last axis, reducing over every other
    one. Training normalises by the batch's mean and biased variance
    (``mean(x^2) - mean(x)^2``, clipped at 0: flax's fast variance) and
    updates the running statistics in place, ``r = m r + (1 - m) stat``
    with flax's momentum m; evaluation normalises by the running
    statistics. ``weight`` / ``bias`` are flax's ``scale`` / ``bias``,
    ``running_mean`` / ``running_var`` (persistent buffers) its
    ``batch_stats`` ``mean`` / ``var``. ``nn.BatchNorm1d`` differs: it
    keeps the unbiased variance and its momentum is 1 - m. On a bf16 input
    (a bf16 flow) it follows flax's rule (``force_float32_reductions``):
    the statistics, their running update and the normalisation in float32,
    the result in the input's dtype; the running statistics stay float32."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5) -> None:
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        dtype = x.dtype
        x = widen(x)
        if training:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return ((x - mean) * (torch.rsqrt(var + self.epsilon) * self.weight)
                + self.bias).to(dtype)


def orthogonal_(tensor: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> None:
    """flax's ``orthogonal`` init, drawn from ``generator``."""
    _fill_(tensor, lambda t: nn.init.orthogonal_(t, generator=generator),
           generator)


def normal_(tensor: torch.Tensor, std: float,
            generator: Optional[torch.Generator] = None) -> None:
    _fill_(tensor, lambda t: t.normal_(0.0, std, generator=generator),
           generator)


def flax_dense(in_features: int, out_features: int,
               generator: Optional[torch.Generator] = None,
               init_: Callable = lecun_normal_) -> nn.Linear:
    """An ``nn.Linear`` initialised as flax's ``nn.Dense``: ``init_`` on the
    weight (flax's default lecun normal), the bias 0."""
    layer = nn.Linear(in_features, out_features)
    init_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


def torch_dense_init_(layer: nn.Linear,
                      generator: Optional[torch.Generator] = None) -> None:
    """``nn.Linear``'s own default init, from an explicit generator:
    kaiming-uniform(a=sqrt(5)) weight = U(+-1/sqrt(fan_in)), and bias
    U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(layer.in_features)
    _uniform_(layer.weight, bound, generator)
    _uniform_(layer.bias, bound, generator)


#: per-joint identity value of each raw output representation
_IDENTITY_FEATURES = {
    MovementsModelOutputType.pose_changes: (1., 0., 0., 0., 1., 0.),
    MovementsModelOutputType.relative_rot: (1., 0., 0., 0., 1., 0.),
    MovementsModelOutputType.absolute_loc: (0., 0., 0.),
    MovementsModelOutputType.absolute_loc_rot:
        (0., 0., 0., 1., 0., 0., 0., 1., 0.),
    MovementsModelOutputType.pose_2d: (0., 0.),
}


def identity_head_init_(layer: nn.Linear,
                        output_type: MovementsModelOutputType,
                        kernel_scale: float = 0.1,
                        generator: Optional[torch.Generator] = None) -> None:
    """Output-head init that lands in the identity neighbourhood of the
    output representation: weight U(+-kernel_scale/sqrt(fan_in)), bias the
    identity value tiled per joint (the 6D identity rotation for
    pose_changes / relative_rot; a zero 6D vector would Gram-Schmidt to a
    zero matrix)."""
    ident = np.asarray(_IDENTITY_FEATURES[output_type], np.float32)
    if layer.out_features % len(ident):
        raise ValueError(f"head width {layer.out_features} is not a multiple "
                         f"of {len(ident)}")
    _uniform_(layer.weight, kernel_scale / math.sqrt(layer.in_features),
              generator)
    with torch.no_grad():
        layer.bias.copy_(torch.from_numpy(
            np.tile(ident, layer.out_features // len(ident))))


class MovementsModel(nn.Module):
    """Base of movements models: ``input_nodes`` / ``output_nodes`` /
    ``movements_output_type`` config and the output formatting."""
    needs_targets = False

    def __init__(self, input_nodes: Type[Skeleton] = CARLA_SKELETON,
                 output_nodes: Type[Skeleton] = CARLA_SKELETON,
                 movements_output_type: MovementsModelOutputType =
                 MovementsModelOutputType.pose_changes,
                 needs_confidence: bool = False) -> None:
        super().__init__()
        self.input_nodes = input_nodes
        self.output_nodes = output_nodes
        self.movements_output_type = movements_output_type
        #: the flow's data then carries a confidence channel: a model that
        #: reads every channel is ``input_features`` wide per joint
        self.needs_confidence = needs_confidence

    @property
    def output_type(self) -> MovementsModelOutputType:
        return self.movements_output_type

    @property
    def eval_slice(self):
        """Frame slice valid for evaluation."""
        return slice(None)

    @property
    def input_features(self) -> int:
        """Channels per joint of the inputs: (x, y), and the confidence
        when ``needs_confidence``."""
        return 3 if self.needs_confidence else 2

    @property
    def output_features(self) -> int:
        return movements_output_features(self.movements_output_type)

    def format_output(self, outputs):
        return format_movements_output(outputs, self.movements_output_type)

    @staticmethod
    def supported_output_types():
        return list(MovementsModelOutputType)


class FixedOutputModel(MovementsModel):
    """A movements model with one output type, its class's
    ``OUTPUT_TYPE``."""
    OUTPUT_TYPE = MovementsModelOutputType.absolute_loc

    def __init__(self, **kwargs) -> None:
        super().__init__(movements_output_type=self.OUTPUT_TYPE, **kwargs)

    @classmethod
    def supported_output_types(cls):
        return [cls.OUTPUT_TYPE]
