"""Minimal datamodule interface: a datamodule yields ``(inputs, targets,
meta)`` batches of tensors on its device.

* ``inputs``  -- (B, L, J, 2|3) float32
* ``targets`` -- dict of (B, ...) tensors
* ``meta``    -- dict; includes ``age_gender_idx`` (B,) int64 for the
  projection's reference-skeleton gather
"""
import os
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Tuple, Type)

import numpy as np
import torch

from ...skeletons.base import Skeleton
from ...skeletons.carla import CARLA_SKELETON
from ...utils.device import DeviceLike, resolve_device

Batch = Tuple[Any, Dict[str, Any], Dict[str, Any]]


def _concatenated(trees: List[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """The first tree's keys, each concatenated over the trees; a key that
    some tree lacks, or whose arrays do not concatenate, is left out."""
    out = {}
    for k in trees[0]:
        try:
            out[k] = np.concatenate([t[k] for t in trees])
        except (ValueError, KeyError):
            continue
    return out


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
                 outputs_dir: str = "outputs",
                 device: DeviceLike = None,
                 **kwargs) -> None:
        self.batch_size = batch_size
        self.clip_length = clip_length
        self.data_nodes = data_nodes
        self.input_nodes = input_nodes or data_nodes
        self.transform = transform
        self.needs_confidence = needs_confidence
        self.outputs_dir = outputs_dir
        self.device = resolve_device(device)

    # -- lifecycle ---------------------------------------------------------
    def prepare_data(self) -> None:
        """One-time preparation (subset extraction and caching)."""

    def setup(self, stage: Optional[str] = None) -> None:
        """Per-stage dataset construction."""

    def train_batches(self, seed: int = 0) -> Iterator[Batch]:
        raise NotImplementedError

    def train_stream(self, seed: int = 0
                     ) -> Tuple[Iterator, Optional[Callable]]:
        """The train batches in two halves for the trainer's prefetcher:
        an iterator of each batch's host half (CPU tensors) and
        ``finish(host) -> batch``, which makes the batch on the device;
        here the whole batches and None, for a datamodule that makes its
        batches on its device."""
        return self.train_batches(seed), None

    def val_batches(self) -> Iterator[Batch]:
        raise NotImplementedError

    def test_batches(self) -> Iterator[Batch]:
        raise NotImplementedError

    def predict_batches(self, set_name: str) -> Iterator[Batch]:
        """The batches ``Trainer.predict`` runs for ``set_name``."""
        if set_name == "train":
            return self.train_batches()
        return self.val_batches() if set_name == "val" else self.test_batches()

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

    # -- predictions as a dataset -----------------------------------------
    def save_predictions(self, set_name: str, outputs, run_id: str = "run"
                         ) -> str:
        """Write the predicted 2D poses of ``Trainer.predict``'s ``outputs``
        (``(preds, targets, meta)`` numpy trees), denormalised where the
        targets carry the shift and scale, with their targets (but the
        ``projection_2d*`` ones) and numeric metas, as
        ``{set_name}.hdf5`` of an HDF5 subsets tree, and the set's size
        into its ``dparams.yaml``, in the JAX package's layout: a
        ``SubsetsDataModule`` (``--subsets_dir``) of either package trains
        on it. Returns the tree's directory,
        ``{outputs_dir}/{datamodule}Predictions/subsets/{digest}/{run_id}``.
        ``h5py`` and ``yaml`` are imported here."""
        import yaml

        from ...ops import normalization as N
        from .hdf5_utils import save_subset

        digest = getattr(self, "settings_digest", "predictions")
        save_dir = os.path.join(
            self.outputs_dir, f"{type(self).__name__}Predictions",
            "subsets", digest, run_id)
        os.makedirs(save_dir, exist_ok=True)
        if not outputs:
            raise ValueError(
                f"save_predictions({set_name!r}): Trainer.predict yielded no "
                f"batches; nothing to save")
        all_proj, all_targets, all_meta = [], [], []
        for preds, targets, meta in outputs:
            key = "projection_2d_transformed" \
                if preds.get("projection_2d_transformed") is not None \
                else "projection_2d"
            pred_pose = np.asarray(preds[key])[..., :2]
            if key == "projection_2d_transformed" \
                    and targets.get("projection_2d_shift") is not None:
                ss = N.ShiftScale(
                    torch.from_numpy(np.asarray(
                        targets["projection_2d_shift"])),
                    torch.from_numpy(np.asarray(
                        targets["projection_2d_scale"])))
                pred_pose = N.denormalize(torch.from_numpy(pred_pose),
                                          ss).numpy()
            all_proj.append(pred_pose)
            all_targets.append({
                k: np.asarray(v) for k, v in targets.items()
                if not k.startswith("projection_2d")
                and hasattr(v, "shape")})
            all_meta.append({k: np.asarray(v) for k, v in (meta or {}).items()
                             if hasattr(v, "shape")})

        projection_2d = np.concatenate(all_proj)
        save_subset(os.path.join(save_dir, f"{set_name}.hdf5"),
                    projection_2d, _concatenated(all_targets),
                    _concatenated(all_meta))

        # the set's size goes beside the others' already there
        params_path = os.path.join(save_dir, "dparams.yaml")
        sizes = {}
        if os.path.exists(params_path):
            with open(params_path) as f:
                sizes = yaml.safe_load(f) or {}
        sizes[f"{set_name}_set_size"] = int(len(projection_2d))
        sizes.setdefault("data_module_name",
                         f"{type(self).__name__}Predictions")
        sizes.setdefault("clip_length", self.clip_length)
        sizes.setdefault("data_nodes", self.data_nodes.__name__)
        with open(params_path, "w") as f:
            yaml.safe_dump(sizes, f)
        return save_dir

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
