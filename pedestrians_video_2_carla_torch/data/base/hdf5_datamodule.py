"""HDF5-cached datamodule base: settings-digest-keyed subset preparation,
in-memory subsets, and batched iteration through the preprocessing graph.

The preparation pipeline (``_read_data -> _clean_filter_sort_data ->
_extract_clips -> _extract_additional_data -> _clean_filter_sort_clips ->
_split_and_save_clips``) and the digest-keyed cache layout are the JAX
package's, so the subsets on disk are interchangeable. Each batch is
sliced from the in-memory numpy subset on the host (or gathered from the
subset's flat binary cache by the native loader,
``runtime/native_loader.py``, where :meth:`Hdf5DataModule.build_native_cache`
made one), copied to the datamodule's device and pushed through
``ops.preprocessing.process_batch`` there. ``train_stream`` hands the two
halves to the trainer apart, so that its prefetcher makes the copies and
the preprocessing of the next batches on a side stream.

With ``device_resident`` every numeric subset is put on the device once,
and a batch is a row gather there: ``resident_scan_inputs`` gives an
epoch's spec (the gather, the seed stream, the order on the device, the
number of batches and the resident tensors), which per-batch iteration and
the epoch runner (``runtime/resident_scan.py``) share. The batch index may
be a device tensor, so that a CUDA graph of the gather reads it at each
replay. Resident batches draw their randomness from the streamed path's
seeds and equal its batches bit for bit; where preprocessing draws nothing
it runs once over the whole subset and an epoch only gathers rows.

``setup`` hands each subset it loads to :meth:`Hdf5DataModule.add_subset`,
which takes plain numpy arrays, so a caller can also feed subsets made in
memory (a machine without h5py). ``yaml`` and ``h5py`` are imported only
where the settings file and the subsets are read or written.
"""
import copy
import functools
import hashlib
import os
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch

from ...ops.preprocessing import (PreprocessingConfig, is_deterministic,
                                  process_batch)
from ...skeletons.carla import age_gender_to_index
from .datamodule import BaseDataModule, batch_seed
from .hdf5_utils import load_subset, save_subset

SUBSETS_BASE = "subsets"
SETS = ("train", "val", "test")


def _host(a: np.ndarray) -> torch.Tensor:
    """A numpy batch array as a CPU tensor; float64 becomes float32, as the
    JAX package's arrays are."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.float() if t.dtype == torch.float64 else t


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on ``device`` (:func:`_host`)."""
    return _host(a).to(device)


def _numeric(a) -> bool:
    return isinstance(a, np.ndarray) and a.dtype.kind in "biuf"


class ResidentSpec(NamedTuple):
    """One epoch over a device-resident subset.

    ``gather(generator, order, b, *trees)`` makes batch ``b`` (an int or a
    (1,) int64 tensor on the device) from the resident ``trees``;
    ``generator`` is seeded with ``batch_seed(stream, b)`` where ``draws``
    (else it may be None). ``order`` holds ``num_batches * batch_size``
    row indices on the device."""
    gather: Callable
    stream: int
    order: torch.Tensor
    num_batches: int
    trees: tuple
    draws: bool


def _batch_rows(order: torch.Tensor, b, batch_size: int) -> torch.Tensor:
    """Batch ``b``'s rows of ``order``, read on the device: a tensor index
    is not baked into a captured graph as a Python slice would be."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((1,), int(b), dtype=torch.int64, device=order.device)
    return order.view(-1, batch_size).index_select(0, b.view(1)).view(-1)


def _clip_size(meta: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    if "clip_width" not in meta:
        return None
    return torch.stack([meta["clip_width"], meta["clip_height"]],
                       dim=-1).float()


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
                 fast_dev_run: bool = False,
                 device_resident: bool = False,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        #: keep each numeric subset on the device (module docstring)
        self.device_resident = device_resident
        #: read only the start of the source data (the CSV's first 18,000
        #: rows, ``PandasDataModuleMixin._read_data``)
        self._fast_dev_run = fast_dev_run
        self._resident: Dict[str, tuple] = {}
        self._resident_pre: Dict[tuple, tuple] = {}
        self._native_caches: Dict[str, Any] = {}
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
        """What the subsets depend on: its digest names their directory.
        A ``fast_dev_run`` prepare reads a cut of the data, so it is in
        the settings when it is true, and full-run settings (and digests)
        stay the JAX package's."""
        settings = {
            "data_module_name": type(self).__name__,
            "clip_length": self.clip_length,
            "clip_offset": self.clip_offset,
            "data_nodes": self.data_nodes.__name__,
        }
        if self._fast_dev_run:
            settings["fast_dev_run"] = True
        return settings

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

    def build_native_cache(self, name: str, hdf5_path: str) -> None:
        """Render subset ``name`` (projection_2d and its numeric targets)
        into the flat binary cache ``<hdf5_path without .hdf5>.bin`` with
        its JSON sidecar, unless one newer than ``hdf5_path`` is there, and
        gather the subset's streamed batches from it with the native loader.
        Where the loader cannot be built, a warning, and the batches are
        sliced with numpy (the same values). Only a caller that asks for it
        takes this path: on the card it is slower than numpy's slice of the
        subset in memory (``PERF.md``), and the cache is a second copy of
        the subset on disk."""
        from ...runtime.native_loader import (BinarySubsetCache,
                                              native_loader_available)
        if not native_loader_available():
            return
        projection_2d, targets, _ = self._subsets[name]
        if not len(projection_2d):
            return
        bin_path = hdf5_path[:-len(".hdf5")] + ".bin" \
            if hdf5_path.endswith(".hdf5") else hdf5_path + ".bin"
        stale = not (os.path.exists(bin_path)
                     and os.path.exists(bin_path + ".json")) or (
            os.path.exists(hdf5_path)
            and os.path.getmtime(bin_path) < os.path.getmtime(hdf5_path))
        if stale:
            BinarySubsetCache.write(bin_path, {
                "projection_2d": projection_2d,
                **{f"targets/{k}": v for k, v in targets.items()
                   if _numeric(v)}})
        self._native_caches[name] = BinarySubsetCache(bin_path)

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
        self._native_caches.pop(name, None)
        self._resident.pop(name, None)
        for key in [k for k in self._resident_pre if k[0] == name]:
            del self._resident_pre[key]
        if self.device_resident and n:
            # one host -> device copy of the subset; its numeric targets
            # and metas only
            self._resident[name] = (
                _tensor(projection_2d, self.device),
                {k: _tensor(v, self.device) for k, v in targets.items()
                 if _numeric(v)},
                {k: _tensor(v, self.device) for k, v in meta.items()
                 if _numeric(v)})

    # -- the resident epoch ------------------------------------------------
    def _resident_gather(self, training: bool) -> Callable:
        """``(generator, order, b, proj, targets, meta) -> batch``: batch
        ``b``'s rows gathered from the resident subset and preprocessed
        with ``generator``, as the streamed path makes it."""
        cfg = self.preprocessing
        batch_size = self.batch_size

        def gather(generator, order, b, proj, targets, meta):
            idx = _batch_rows(order, b, batch_size)
            batch_targets = {k: v.index_select(0, idx)
                             for k, v in targets.items()}
            batch_meta = {k: v.index_select(0, idx) for k, v in meta.items()}
            inputs, proc_targets = process_batch(
                generator, proj.index_select(0, idx), cfg, training,
                bboxes=batch_targets.get("bboxes"),
                clip_size=_clip_size(batch_meta))
            batch_targets.update(proc_targets)
            return inputs, batch_targets, batch_meta

        return gather

    def _resident_preprocessed(self, name: str, training: bool) -> tuple:
        """The resident subset with the preprocessing run once over all of
        it, for a configuration that draws nothing: every step of
        ``process_batch`` is then a map of each clip on its own, so an
        epoch only gathers rows (within float rounding of the per-batch
        path: a reduction over a clip may group its sums otherwise at
        another batch size)."""
        key = (name, training)
        if key not in self._resident_pre:
            proj, targets, meta = self._resident[name]
            inputs, proc_targets = process_batch(
                None, proj, self.preprocessing, training,
                bboxes=targets.get("bboxes"), clip_size=_clip_size(meta))
            self._resident_pre[key] = (inputs, {**targets, **proc_targets},
                                       meta)
        return self._resident_pre[key]

    def _resident_gather_pre(self) -> Callable:
        """Row gather over the preprocessed resident subset (the signature
        of :meth:`_resident_gather`; the generator is unused)."""
        batch_size = self.batch_size

        def gather(generator, order, b, inputs, targets, meta):
            idx = _batch_rows(order, b, batch_size)
            return (inputs.index_select(0, idx),
                    {k: v.index_select(0, idx) for k, v in targets.items()},
                    {k: v.index_select(0, idx) for k, v in meta.items()})

        return gather

    def _epoch_order(self, n: int, shuffle: bool, training: bool,
                     seed: int):
        """(order, seed stream, number of batches) of an epoch over ``n``
        clips: the shuffle, the batch seeds and the padding that the
        streamed and the resident paths share."""
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
        return order[:num_batches * self.batch_size], stream, num_batches

    def resident_scan_inputs(self, name: str, shuffle: bool, training: bool,
                             seed: int = 0) -> Optional[ResidentSpec]:
        """The spec of one epoch over the resident subset ``name``
        (:class:`ResidentSpec`), or None where it is not resident (an
        empty subset is never resident). Its order, seeds and padding are
        the streamed path's."""
        if name not in self._resident:
            return None
        order, stream, num_batches = self._epoch_order(
            len(self._subsets[name][0]), shuffle, training, seed)
        order_d = torch.from_numpy(order.astype(np.int64)).to(self.device)
        if is_deterministic(self.preprocessing, training):
            return ResidentSpec(self._resident_gather_pre(), stream, order_d,
                                num_batches,
                                self._resident_preprocessed(name, training),
                                False)
        return ResidentSpec(self._resident_gather(training), stream, order_d,
                            num_batches, self._resident[name], True)

    def _iter_subset_resident(self, name: str, shuffle: bool,
                              training: bool, seed: int = 0) -> Iterator:
        spec = self.resident_scan_inputs(name, shuffle, training, seed)
        if spec is None:
            return
        for b in range(spec.num_batches):
            generator = None
            if spec.draws:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(batch_seed(spec.stream, b))
            yield spec.gather(generator, spec.order, b, *spec.trees)

    def _host_batches(self, name: str, shuffle: bool, training: bool,
                      seed: int = 0) -> Iterator:
        """The host half of the streamed batches of subset ``name``:
        ``(raw, targets, meta, seed)`` each, CPU tensors of the batch's
        rows (numeric targets and metas only), and the seed of the batch's
        preprocessing where it draws (else None)."""
        projection_2d, targets, meta = self._subsets[name]
        n = len(projection_2d)
        if n == 0:
            return
        order, stream, num_batches = self._epoch_order(n, shuffle, training,
                                                       seed)
        draws = not is_deterministic(self.preprocessing, training)
        native = self._native_caches.get(name)
        for b in range(num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if native is not None:
                gathered = native.gather(idx)
                raw = gathered["projection_2d"]
                batch_targets = {k: _host(gathered[f"targets/{k}"])
                                 for k, v in targets.items() if _numeric(v)}
            else:
                raw = projection_2d[idx]
                batch_targets = {k: _host(v[idx]) for k, v in targets.items()
                                 if _numeric(v)}
            batch_meta = {k: _host(v[idx]) for k, v in meta.items()
                          if _numeric(v)}
            yield (_host(raw), batch_targets, batch_meta,
                   batch_seed(stream, b) if draws else None)

    def _finish(self, host: tuple, training: bool):
        """A host batch (:meth:`_host_batches`) on the device (where it is
        not there yet), through ``process_batch`` with the batch's own
        generator."""
        raw, targets, meta, seed = host
        device = self.device
        targets = {k: v.to(device) for k, v in targets.items()}
        meta = {k: v.to(device) for k, v in meta.items()}
        generator = None
        if seed is not None:
            generator = torch.Generator(device=device)
            generator.manual_seed(seed)
        inputs, proc_targets = process_batch(
            generator, raw.to(device), self.preprocessing, training,
            bboxes=targets.get("bboxes"), clip_size=_clip_size(meta))
        targets.update(proc_targets)
        return inputs, targets, meta

    def _iter_subset(self, name: str, shuffle: bool, training: bool,
                     seed: int = 0) -> Iterator:
        if name not in self._subsets:
            return
        if name in self._resident:
            yield from self._iter_subset_resident(name, shuffle, training,
                                                  seed)
            return
        for host in self._host_batches(name, shuffle, training, seed):
            yield self._finish(host, training)

    def train_stream(self, seed: int = 0) -> Tuple[Iterator,
                                                   Optional[Callable]]:
        """The streamed train batches in their two halves
        (``BaseDataModule.train_stream``); a resident subset's batches are
        made whole on the device."""
        if "train" not in self._subsets or "train" in self._resident:
            return super().train_stream(seed)
        return (self._host_batches("train", True, True, seed),
                functools.partial(self._finish, training=True))

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
