"""Minimal datamodule interface: a datamodule yields ``(inputs, targets,
meta)`` batches of tensors on its device.

* ``inputs``  -- (B, L, J, 2|3) float32
* ``targets`` -- dict of (B, ...) tensors
* ``meta``    -- dict; includes ``age_gender_idx`` (B,) int64 for the
  projection's reference-skeleton gather
"""
from typing import Any, Dict, Iterator, Optional, Tuple, Type

import numpy as np

from ...skeletons.base import Skeleton
from ...skeletons.carla import CARLA_SKELETON
from ...utils.device import DeviceLike, resolve_device

Batch = Tuple[Any, Dict[str, Any], Dict[str, Any]]


def batch_seed(base: int, index: int) -> int:
    """Independent seed of batch ``index`` of the stream ``base``."""
    return int(np.random.SeedSequence([base, index]).generate_state(1)[0])


class BaseDataModule:
    #: subclasses that generate infinite train streams say so (the trainer
    #: then bounds an epoch when ``limit_train_batches`` is not given)
    @classmethod
    def uses_infinite_train_set(cls) -> bool:
        return False

    def __init__(self,
                 batch_size: int = 64,
                 clip_length: int = 30,
                 data_nodes: Type[Skeleton] = CARLA_SKELETON,
                 input_nodes: Optional[Type[Skeleton]] = None,
                 transform: str = "hips_neck",
                 needs_confidence: bool = False,
                 device: DeviceLike = None,
                 **kwargs) -> None:
        self.batch_size = batch_size
        self.clip_length = clip_length
        self.data_nodes = data_nodes
        self.input_nodes = input_nodes or data_nodes
        self.transform = transform
        self.needs_confidence = needs_confidence
        self.device = resolve_device(device)

    # -- lifecycle ---------------------------------------------------------
    def prepare_data(self) -> None:
        """One-time preparation (subset extraction and caching)."""

    def setup(self, stage: Optional[str] = None) -> None:
        """Per-stage dataset construction."""

    def train_batches(self, seed: int = 0) -> Iterator[Batch]:
        raise NotImplementedError

    def val_batches(self) -> Iterator[Batch]:
        raise NotImplementedError

    def test_batches(self) -> Iterator[Batch]:
        raise NotImplementedError

    # -- sizes (None = unknown/infinite) ----------------------------------
    @property
    def train_set_size(self) -> Optional[int]:
        return None

    @property
    def val_set_size(self) -> Optional[int]:
        return None

    @property
    def test_set_size(self) -> Optional[int]:
        return None

    @property
    def hparams(self) -> Dict[str, Any]:
        return {
            "data_module_name": type(self).__name__,
            "batch_size": self.batch_size,
            "clip_length": self.clip_length,
            "data_nodes": self.data_nodes.__name__,
            "input_nodes": self.input_nodes.__name__,
            "transform": self.transform,
        }
