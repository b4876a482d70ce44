"""Mixed datamodules: N member datamodules whose batches are interleaved
in given proportions, each batch aligned to the union of the members'
target keys (a key a member lacks becomes a (B, 1) NaN tensor; the
``mappings`` rename keys first, so that two members' labels meet under
one name).

Each member yields its batches already on the shared ``input_nodes``
skeleton (its own preprocessing maps the joints). The interleave order is
drawn from numpy's ``default_rng(1234 + seed)``, so that it is the JAX
package's. The combos: ``JAADCarlaRec``, ``JAADCarlaRecAMASS``,
``CarlaRecAMASS`` and ``JAADCarlaRecBenchmark``.

A mixed module streams its members' batches whole: it has no resident
subsets (``device_resident`` is refused) and no infinite train set.
"""
from typing import Dict, Iterable, Iterator, List, Optional, Type

import numpy as np
import torch

from ...skeletons.base import Skeleton, get_common_indices
from ...skeletons.carla import CARLA_SKELETON
from ..base.datamodule import BaseDataModule
from ..carla.carla_recorded import (CarlaBenchmarkDataModule,
                                    CarlaRecordedDataModule)
from ..openpose.datamodules import (JAADBenchmarkDataModule,
                                    JAADOpenPoseDataModule)
from ..smpl.amass import AMASSDataModule

#: the keyword arguments the mixed module itself keeps (all go to the
#: members too)
_OWN_KWARGS = ("batch_size", "clip_length", "data_nodes", "input_nodes",
               "transform", "needs_confidence", "outputs_dir", "device")


def map_missing_joint_probabilities(probabilities: List[float],
                                    input_nodes: Type[Skeleton],
                                    output_nodes: Type[Skeleton]
                                    ) -> List[float]:
    """Per-joint missing probabilities moved from one skeleton to another;
    a joint without a counterpart gets their mean."""
    if len(probabilities) <= 1:
        return list(probabilities)
    probs = np.asarray(probabilities)
    mean = probs.mean()
    out_idx, in_idx = get_common_indices(input_nodes, output_nodes)
    mapped = np.full(len(output_nodes), mean)
    mapped[out_idx] = probs[in_idx]
    return mapped.tolist()


class MixedDataModule(BaseDataModule):
    #: member classes and default proportions; subclasses set them
    data_modules: List[type] = []
    train_proportions: List[float] = []
    val_proportions: List[float] = []
    test_proportions: List[float] = []

    def __init__(self,
                 data_modules: Optional[List[type]] = None,
                 data_modules_kwargs: Optional[Dict[type, Dict]] = None,
                 train_proportions: Optional[List[float]] = None,
                 val_proportions: Optional[List[float]] = None,
                 test_proportions: Optional[List[float]] = None,
                 mappings: Optional[Dict[str, str]] = None,
                 **kwargs) -> None:
        all_modules = list(self.data_modules) + list(data_modules or [])
        if len(all_modules) < 2:
            raise AssertionError("At least 2 data modules are required")
        if kwargs.get("device_resident"):
            raise ValueError(
                f"{type(self).__name__}: a mixed data module streams its "
                f"members' batches; device_resident (the resident and "
                f"graphed epochs) takes a single data module")
        kwargs.setdefault("input_nodes", CARLA_SKELETON)
        super().__init__(**{k: v for k, v in kwargs.items()
                            if k in _OWN_KWARGS})
        kwargs["device"] = self.device
        data_modules_kwargs = data_modules_kwargs or {}
        self.mappings = mappings or {}
        self._members: List[BaseDataModule] = [
            cls(**{**kwargs, **data_modules_kwargs.get(cls, {})})
            for cls in all_modules]

        self.requested_train_proportions = self._validate(
            train_proportions or self.train_proportions)
        self.requested_val_proportions = self._validate(
            val_proportions or self.val_proportions)
        self.requested_test_proportions = self._validate(
            test_proportions or self.test_proportions)

    @property
    def members(self) -> List[BaseDataModule]:
        return self._members

    def _validate(self, proportions: List[float]) -> List[float]:
        """Proportions that sum to 1, each in [0, 1]; or only -1 and 0
        (-1: every batch of the member, 0: none); none given is all -1."""
        if not proportions:
            proportions = [-1] * len(self._members)
        # AssertionError, as the JAX package's asserts raise (and under -O)
        if len(proportions) != len(self._members):
            raise AssertionError(f"{len(proportions)} proportions for "
                                 f"{len(self._members)} data modules")
        if not ((all(0 <= p <= 1 for p in proportions)
                 and abs(sum(proportions) - 1) < 1e-6)
                or all(p in (0, -1) for p in proportions)):
            raise AssertionError(f"proportions {proportions}: each in "
                                 f"[0, 1] summing to 1, or each -1 or 0")
        return proportions

    @classmethod
    def uses_infinite_train_set(cls) -> bool:
        return False

    @property
    def subsets_dir(self) -> List[str]:
        return [getattr(dm, "subsets_dir", None) for dm in self._members]

    @property
    def class_labels(self):
        return getattr(self._members[0], "class_labels", None)

    def prepare_data(self) -> None:
        for dm in self._members:
            dm.prepare_data()

    def setup(self, stage: Optional[str] = None) -> None:
        for dm in self._members:
            dm.setup(stage)

    # -- batch alignment ---------------------------------------------------
    def _align(self, batch, template_keys: Iterable[str]):
        inputs, targets, meta = batch
        targets = dict(targets)
        for old, new in self.mappings.items():
            if old in targets and new not in targets:
                targets[new] = targets.pop(old)
        aligned = {}
        B = inputs.shape[0]
        for k in template_keys:
            if k in targets:
                aligned[k] = targets[k]
            else:
                aligned[k] = torch.full((B, 1), float("nan"),
                                        dtype=torch.float32,
                                        device=inputs.device)
        return inputs, aligned, meta

    def _template_keys(self, batches_by_member) -> List[str]:
        """The union of the members' target keys, renamed by the
        mappings, in the order the members first show them."""
        keys: List[str] = []
        for b in batches_by_member:
            if b is None:
                continue
            t = dict(b[1])
            for old, new in self.mappings.items():
                if old in t:
                    t[new] = t.pop(old)
            for k in t.keys():
                if k not in keys:
                    keys.append(k)
        return keys

    def _mix(self, iterators: List[Optional[Iterable]],
             proportions: List[float], seed: int = 0) -> Iterator:
        """The members' batches, aligned, until every member in use runs
        out: each next batch from a member drawn with the proportions'
        weights among those with batches left (a -1 weighs 1)."""
        iterators = [iter(it) if it is not None else None
                     for it in iterators]
        firsts = []
        for it in iterators:
            try:
                firsts.append(next(it) if it is not None else None)
            except StopIteration:
                firsts.append(None)
        template = self._template_keys(firsts)
        use = [p != 0 for p in proportions]
        weights = np.asarray([max(p, 0) if p >= 0 else 1.0
                              for p in proportions], dtype=np.float64)
        if weights.sum() == 0:
            weights = np.ones(len(proportions))
        weights = weights / weights.sum()
        rng = np.random.default_rng(1234 + seed)

        pending = list(firsts)
        alive = [use[i] and pending[i] is not None
                 for i in range(len(iterators))]
        while any(alive):
            choices = np.nonzero(alive)[0]
            i = rng.choice(choices, p=weights[choices] /
                           weights[choices].sum())
            yield self._align(pending[i], template)
            try:
                pending[i] = next(iterators[i])
            except StopIteration:
                alive[i] = False

    def train_batches(self, seed: int = 0) -> Iterator:
        return self._mix([dm.train_batches(seed) for dm in self._members],
                         self.requested_train_proportions, seed)

    def val_batches(self) -> Iterator:
        return self._mix([dm.val_batches() for dm in self._members],
                         self.requested_val_proportions)

    def test_batches(self) -> Iterator:
        return self._mix([dm.test_batches() for dm in self._members],
                         self.requested_test_proportions)

    # train_stream is BaseDataModule's: the mixed batches whole, made on the
    # device by the members (on the trainer's prefetcher thread)

    @property
    def hparams(self):
        return {**super().hparams,
                "data_module_name": type(self).__name__,
                "mixed_datasets": [type(dm).__name__
                                   for dm in self._members],
                "train_proportions": self.requested_train_proportions,
                "val_proportions": self.requested_val_proportions,
                "test_proportions": self.requested_test_proportions}


class JAADCarlaRecDataModule(MixedDataModule):
    data_modules = [JAADOpenPoseDataModule, CarlaRecordedDataModule]
    mappings = {"frame.pedestrian.is_crossing": "crossing"}

    def __init__(self, **kwargs):
        kwargs.setdefault("mappings", self.mappings)
        super().__init__(**kwargs)


class JAADCarlaRecAMASSDataModule(MixedDataModule):
    data_modules = [JAADOpenPoseDataModule, CarlaRecordedDataModule,
                    AMASSDataModule]
    mappings = {"frame.pedestrian.is_crossing": "crossing"}

    def __init__(self, **kwargs):
        kwargs.setdefault("mappings", self.mappings)
        super().__init__(**kwargs)


class CarlaRecAMASSDataModule(MixedDataModule):
    data_modules = [CarlaRecordedDataModule, AMASSDataModule]


class JAADCarlaRecBenchmarkDataModule(MixedDataModule):
    data_modules = [JAADBenchmarkDataModule, CarlaBenchmarkDataModule]
    mappings = {"frame.pedestrian.is_crossing": "crossing"}

    def __init__(self, **kwargs):
        kwargs.setdefault("mappings", self.mappings)
        super().__init__(**kwargs)
