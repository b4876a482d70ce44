"""Classification model base (reference
``modules/classification/classification.py:5-19``) and what the classifiers
share: the seeded flax-family inits for (in, out) parameters and dropout
from an explicit generator."""
import math
from typing import Optional, Type

import torch
from torch import nn

from ...flows.output_types import ClassificationModelOutputType
from ...skeletons.base import Skeleton
from ...skeletons.carla import CARLA_SKELETON
from ..movements.common import (_fill_, dropout, orthogonal_,  # noqa: F401
                               trunc_normal_)


class ClassificationModel(nn.Module):
    """Base of the crossing classifiers: (B, L, J, C) clips -> (B,
    num_classes) logits. ``forward(x, targets=None, training=False,
    generator=None)``; ``generator`` draws the dropout masks when
    ``training``."""
    needs_graph = False
    needs_targets = False

    def __init__(self, input_nodes: Type[Skeleton] = CARLA_SKELETON,
                 num_classes: int = 2, input_features: int = 2,
                 needs_confidence: bool = False) -> None:
        super().__init__()
        self.input_nodes = input_nodes
        self.num_classes = num_classes
        self.input_features = input_features
        self.needs_confidence = needs_confidence

    @property
    def data_features(self) -> int:
        """Channels per joint of the flow's inputs: (x, y), and the
        confidence when ``needs_confidence``. A model that reads every
        channel is this wide per joint; one that keeps the first
        ``input_features`` is at most that wide."""
        return 3 if self.needs_confidence else 2

    @property
    def output_type(self) -> ClassificationModelOutputType:
        return ClassificationModelOutputType.multiclass


def lecun_normal_in_out_(tensor: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> None:
    """flax's ``lecun_normal`` on an (in, out) parameter: a truncated normal
    of variance 1 / in."""
    # 0.8796... is the std of a unit normal truncated at +-2
    trunc_normal_(tensor, math.sqrt(1.0 / tensor.shape[0]) / .87962566103423978,
                  generator)
