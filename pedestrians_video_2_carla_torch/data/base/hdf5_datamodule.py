"""HDF5-cached datamodule base: settings-digest-keyed subset preparation,
in-memory subsets, and batched iteration through the preprocessing graph.

The preparation pipeline (``_read_data -> _clean_filter_sort_data ->
_extract_clips -> _extract_additional_data -> _clean_filter_sort_clips ->
_split_and_save_clips``) and the digest-keyed cache layout are the JAX
package's, so the subsets on disk are interchangeable. Each batch is
sliced from the in-memory numpy subset, copied to the datamodule's device
and pushed through ``ops.preprocessing.process_batch`` there.

``setup`` hands each subset it loads to :meth:`Hdf5DataModule.add_subset`,
which takes plain numpy arrays, so a caller can also feed subsets made in
memory (a machine without h5py). ``yaml`` and ``h5py`` are imported only
where the settings file and the subsets are read or written.
"""
import copy
import hashlib
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ...ops.preprocessing import (PreprocessingConfig, is_deterministic,
                                  process_batch)
from ...skeletons.carla import age_gender_to_index
from .datamodule import BaseDataModule, batch_seed
from .hdf5_utils import load_subset, save_subset

SUBSETS_BASE = "subsets"
SETS = ("train", "val", "test")


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy batch array on ``device``; float64 becomes float32, as the
    JAX package's arrays are."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def _numeric(a) -> bool:
    return isinstance(a, np.ndarray) and a.dtype.kind in "biuf"


class Hdf5DataModule(BaseDataModule):
    def __init__(self,
                 outputs_dir: str = "outputs",
                 subsets_dir: Optional[str] = None,
                 clip_offset: Optional[int] = None,
                 val_set_frac: float = 0.2,
                 test_set_frac: float = 0.2,
                 noise: str = "zero",
                 noise_param: float = 1.0,
                 missing_joint_probabilities=(),
                 augment_flip=False,
                 augment_rotate=False,
                 seed: int = 22742,
                 device_resident: bool = False,
                 **kwargs) -> None:
        if device_resident:
            raise NotImplementedError(
                "device_resident subsets (the JAX package's on-device "
                "gather and epoch scan) are not ported yet: they belong to "
                "M6 of ROADMAP.md")
        super().__init__(**kwargs)
        self.outputs_dir = outputs_dir
        self.clip_offset = clip_offset if clip_offset is not None \
            else self.clip_length
        self.val_set_frac = val_set_frac
        self.test_set_frac = test_set_frac
        self.seed = seed
        self._class_labels: Optional[Dict[str, List[str]]] = None
        self._class_counts: Dict[str, Dict] = {"train": {}, "val": {},
                                               "test": {}}

        self.preprocessing = PreprocessingConfig(
            data_nodes=self.data_nodes,
            input_nodes=self.input_nodes,
            transform=self.transform,
            noise=noise, noise_param=noise_param,
            missing_joint_probabilities=tuple(
                missing_joint_probabilities or ()),
            augment_flip=(0.5 if augment_flip is True else augment_flip)
            or 0.0,
            augment_rotate=(10.0 if augment_rotate is True
                            else augment_rotate) or 0.0,
            needs_confidence=self.needs_confidence,
        )

        self._settings_digest = self._calculate_settings_digest()
        self._subsets_dir = subsets_dir or os.path.join(
            self.outputs_dir, type(self).__name__, SUBSETS_BASE,
            self._settings_digest)
        self._subsets: Dict[str, tuple] = {}
        self._set_size: Dict[str, int] = {}

    # -- settings digest ---------------------------------------------------
    @property
    def settings(self) -> Dict[str, Any]:
        return {
            "data_module_name": type(self).__name__,
            "clip_length": self.clip_length,
            "clip_offset": self.clip_offset,
            "data_nodes": self.data_nodes.__name__,
        }

    def _calculate_settings_digest(self) -> str:
        settings = {k: self.settings[k] for k in sorted(self.settings)}
        return hashlib.md5("-".join(
            f"{k}={v}" for k, v in settings.items()).encode()).hexdigest()

    @property
    def settings_digest(self) -> str:
        return self._settings_digest

    @property
    def subsets_dir(self) -> str:
        return self._subsets_dir

    @property
    def class_labels(self):
        return self._class_labels

    def save_settings(self):
        import yaml

        with open(os.path.join(self._subsets_dir, "dparams.yaml"), "w") as f:
            settings = copy.deepcopy(self.settings)
            settings.update({f"{k}_set_size": v
                             for k, v in self._set_size.items()})
            if self._class_labels is not None:
                settings["class_labels"] = self._class_labels
            if self._class_counts is not None:
                settings["class_counts"] = self._class_counts
            yaml.safe_dump(settings, f)

    # -- preparation pipeline ---------------------------------------------
    def prepare_data(self) -> None:
        if os.path.exists(os.path.join(self._subsets_dir, "dparams.yaml")):
            self._load_set_info()
            return
        os.makedirs(self._subsets_dir, exist_ok=True)
        data = self._read_data()
        data = self._clean_filter_sort_data(data)
        clips = self._extract_clips(data)
        clips = self._extract_additional_data(clips)
        clips = self._clean_filter_sort_clips(clips)
        self._set_size = self._split_and_save_clips(clips)
        self.save_settings()

    def _load_set_info(self):
        import yaml

        with open(os.path.join(self._subsets_dir, "dparams.yaml")) as f:
            params = yaml.safe_load(f)
        self._class_labels = params.get("class_labels")
        self._class_counts = params.get("class_counts", self._class_counts)
        for name in SETS:
            if f"{name}_set_size" in params:
                self._set_size[name] = params[f"{name}_set_size"]

    def _read_data(self):
        raise NotImplementedError

    def _clean_filter_sort_data(self, data):
        return data

    def _extract_clips(self, data):
        raise NotImplementedError

    def _extract_additional_data(self, clips):
        return clips

    def _clean_filter_sort_clips(self, clips):
        return clips

    def _split_and_save_clips(self, clips) -> Dict[str, int]:
        raise NotImplementedError

    def _save_subset(self, name, projection_2d, targets, meta,
                     save_dir=None) -> int:
        path = os.path.join(save_dir or self._subsets_dir, f"{name}.hdf5")
        return save_subset(path, projection_2d, targets, meta)

    # -- setup & iteration -------------------------------------------------
    def setup(self, stage: Optional[str] = None) -> None:
        """Load every saved subset not yet in memory."""
        for name in SETS:
            path = os.path.join(self._subsets_dir, f"{name}.hdf5")
            if os.path.exists(path) and name not in self._subsets:
                self.add_subset(name, *load_subset(path))

    def add_subset(self, name: str, projection_2d: np.ndarray,
                   targets: Dict[str, np.ndarray],
                   meta: Dict[str, Any]) -> None:
        """Hold one subset in memory: (N, L, J_data, 2|3) detections, (N,
        ...) targets and meta (string metas as sequences of str). The
        reference-skeleton index ``age_gender_idx`` is derived from the
        ``age`` / ``gender`` metas (adult / female where absent)."""
        n = len(projection_2d)
        meta = dict(meta)
        meta["age_gender_idx"] = np.asarray([
            age_gender_to_index(a, g) for a, g in
            zip(meta.get("age", ["adult"] * n),
                meta.get("gender", ["female"] * n))], dtype=np.int64)
        self._subsets[name] = (projection_2d, dict(targets), meta)
        self._set_size[name] = n

    def _iter_subset(self, name: str, shuffle: bool, training: bool,
                     seed: int = 0) -> Iterator:
        if name not in self._subsets:
            return
        projection_2d, targets, meta = self._subsets[name]
        n = len(projection_2d)
        if n == 0:
            return
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(self.seed + seed).shuffle(order)
        stream = self.seed + seed + (17 if training else 3)
        num_batches = n // self.batch_size
        if num_batches == 0 or (not training and n % self.batch_size):
            # the final partial batch is padded by wrapping around: shapes
            # stay static, and evaluation covers every sample (at most
            # batch_size - 1 duplicates). Training drops the remainder,
            # unless the whole set is smaller than one batch
            num_batches += 1
            order = np.resize(order, num_batches * self.batch_size)
        cfg = self.preprocessing
        draws = not is_deterministic(cfg, training)
        for b in range(num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            generator = None
            if draws:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(batch_seed(stream, b))
            batch_targets = {k: _tensor(v[idx], self.device)
                             for k, v in targets.items() if _numeric(v)}
            # only numeric meta goes to the device
            batch_meta = {k: _tensor(v[idx], self.device)
                          for k, v in meta.items() if _numeric(v)}
            clip_size = None
            if "clip_width" in batch_meta:
                clip_size = torch.stack([batch_meta["clip_width"],
                                         batch_meta["clip_height"]],
                                        dim=-1).float()
            inputs, proc_targets = process_batch(
                generator, _tensor(projection_2d[idx], self.device), cfg,
                training, bboxes=batch_targets.get("bboxes"),
                clip_size=clip_size)
            batch_targets.update(proc_targets)
            yield inputs, batch_targets, batch_meta

    def train_batches(self, seed: int = 0) -> Iterator:
        return self._iter_subset("train", shuffle=True, training=True,
                                 seed=seed)

    def val_batches(self) -> Iterator:
        return self._iter_subset("val", shuffle=False, training=False)

    def test_batches(self) -> Iterator:
        return self._iter_subset("test", shuffle=False, training=False)

    def predict_batches(self, set_name: str) -> Iterator:
        return self._iter_subset(set_name, shuffle=False, training=False)

    @property
    def train_set_size(self):
        return self._set_size.get("train")

    @property
    def val_set_size(self):
        return self._set_size.get("val")

    @property
    def test_set_size(self):
        return self._set_size.get("test")

    @property
    def hparams(self):
        return {**super().hparams,
                "settings_digest": self._settings_digest,
                "subsets_dir": self._subsets_dir,
                "noise": self.preprocessing.noise,
                "missing_joint_probabilities":
                    list(self.preprocessing.missing_joint_probabilities)}
