"""Port parity for the CarlaRecorded datamodules on the CPU: the JAX
package's fixture ``data.csv`` (4 videos of 40 frames, written once per
module as ``tests/data/test_carla_recorded.py`` writes it), prepared by both
packages' ``CarlaRecordedDataModule`` into separate directories.

Held equal: the settings digest and layout, the set sizes and
``dparams.yaml``, every HDF5 dataset and attribute; each package reads the
other's subsets to the same arrays; no video in two sets; the deterministic
validation batches within 1e-6 of the JAX host path's; the benchmark
variant's time-to-event window; ``recorded_subset`` (a subset made in
memory) against a prepared subset's fields, shapes and dtypes;
``fast_dev_run`` reading the same 18,000-row prefix in both packages; a
2-step ``Trainer`` fit, and the CLI with ``--device_resident``, on the
CPU.
"""
import json
import os

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from pedestrians_video_2_carla_tpu.data.base import hdf5_utils as JU
from pedestrians_video_2_carla_tpu.data.base import pandas_mixin as JP
from pedestrians_video_2_carla_tpu.data.carla import carla_recorded as JC

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.data import discover
from pedestrians_video_2_carla_torch.data.base import hdf5_utils as TU
from pedestrians_video_2_carla_torch.data.base import pandas_mixin as TP
from pedestrians_video_2_carla_torch.data.carla import carla_recorded as TC
from .torch_threads import limit_torch_threads

limit_torch_threads()

N_VIDEOS, N_FRAMES, CLIP_LEN = 4, 40, 8
COMMON = dict(batch_size=4, clip_length=CLIP_LEN, clip_offset=4,
              val_set_frac=0.25, test_set_frac=0.25)
ATOL = 1e-6


@pytest.fixture(scope="module")
def carla_csv(tmp_path_factory):
    """The JAX package's CarlaRecorded fixture: the adult female reference
    pose projected by the JAX FK and camera, jittered per frame."""
    from pedestrians_video_2_carla_tpu.ops.camera import (make_camera,
                                                          project_pose)
    from pedestrians_video_2_carla_tpu.ops.kinematics import \
        forward_kinematics
    from pedestrians_video_2_carla_tpu.skeletons.carla import (
        load_reference_pose, load_reference_pose_carla)

    root = tmp_path_factory.mktemp("carla_recorded")
    rel_loc, rel_rot = load_reference_pose("adult_female")
    abs_loc, _ = forward_kinematics(rel_loc, rel_rot)
    proj = np.asarray(project_pose(make_camera(),
                                   np.asarray(abs_loc)[None]))[0, :, :2]
    carla_loc, carla_pyr, _ = load_reference_pose_carla("adult_female")
    bone_transform = str(np.concatenate([carla_loc, carla_pyr],
                                        axis=-1).tolist())
    rng = np.random.default_rng(0)
    rows = []
    for vid in range(N_VIDEOS):
        for frame in range(N_FRAMES):
            jitter = rng.normal(scale=1.0, size=proj.shape)
            rows.append({
                "id": f"video_{vid:02d}", "camera.idx": 0,
                "pedestrian.idx": 0, "frame.idx": frame,
                "camera.recording": f"video_{vid:02d}.mp4",
                "camera.width": 800, "camera.height": 600,
                "camera.transform": str([3.1, 0, 1.2, 0, 0, 0]),
                "pedestrian.age": "adult",
                "pedestrian.gender": "female" if vid % 2 else "male",
                "pedestrian.spawn_point": str([0, 0, 0, 0, 0, 0]),
                "frame.pedestrian.is_crossing": frame > N_FRAMES // 2,
                "frame.pedestrian.transform": str(
                    [0.1 * frame, 0, 0, 0, 0, 0]),
                "frame.pedestrian.velocity": str([0.1, 0.0, 0.0]),
                "frame.pedestrian.pose.world": bone_transform,
                "frame.pedestrian.pose.component": bone_transform,
                "frame.pedestrian.pose.relative": bone_transform,
                "frame.pedestrian.pose.camera": str(
                    np.clip(proj + jitter, 1, 599).tolist()),
            })
    os.makedirs(root / "default", exist_ok=True)
    pd.DataFrame(rows).to_csv(root / "default" / "data.csv", index=False)
    return str(root)


def _make(carla_csv, out, side, cls="CarlaRecordedDataModule", **kw):
    module = TC if side == "port" else JC
    if side == "port":
        kw.setdefault("device", "cpu")
    dm = getattr(module, cls)(datasets_dir=carla_csv, outputs_dir=str(out),
                              **{**COMMON, **kw})
    dm.prepare_data()
    return dm


@pytest.fixture(scope="module")
def prepared(carla_csv, tmp_path_factory):
    """Both packages' CarlaRecorded, prepared into separate directories."""
    tmp = tmp_path_factory.mktemp("prepared")
    return (_make(carla_csv, tmp / "port", "port"),
            _make(carla_csv, tmp / "jax", "jax"))


def _datasets(path):
    """Every dataset of an HDF5 file: name -> (array, attributes)."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, (
            obj[()], {k: np.asarray(v) for k, v in obj.attrs.items()}))
            if isinstance(obj, h5py.Dataset) else None)
    return out


def _hdf5_names(path):
    return sorted(n for n in os.listdir(path) if n.endswith(".hdf5"))


def _assert_same_subsets(port, ref):
    assert port.settings_digest == ref.settings_digest
    assert port.settings == ref.settings
    assert os.path.relpath(port.subsets_dir, port.outputs_dir) \
        == os.path.relpath(ref.subsets_dir, ref.outputs_dir)
    assert port._set_size == ref._set_size and port._set_size
    with open(os.path.join(port.subsets_dir, "dparams.yaml")) as f, \
            open(os.path.join(ref.subsets_dir, "dparams.yaml")) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    names = _hdf5_names(ref.subsets_dir)
    assert names == _hdf5_names(port.subsets_dir)
    for name in names:
        got = _datasets(os.path.join(port.subsets_dir, name))
        want = _datasets(os.path.join(ref.subsets_dir, name))
        assert set(got) == set(want), name
        for k, (array, attrs) in want.items():
            assert got[k][0].dtype == array.dtype, (name, k)
            np.testing.assert_array_equal(got[k][0], array,
                                          err_msg=f"{name}/{k}")
            assert set(got[k][1]) == set(attrs)
            for a, v in attrs.items():
                np.testing.assert_array_equal(got[k][1][a], v)


def test_subsets_match_jax(prepared):
    port, ref = prepared
    _assert_same_subsets(port, ref)
    assert port.class_labels == {TC.CROSSING_KEY: list(TC.LABELS)}
    assert sum(port._set_size.values()) > 0


def test_registry_names_the_recorded_modules():
    modules = discover()
    assert modules["CarlaRecorded"] is TC.CarlaRecordedDataModule
    assert modules["CarlaBenchmark"] is TC.CarlaBenchmarkDataModule


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_reads_the_others_subsets(prepared, reader):
    port, ref = prepared
    load = TU.load_subset if reader == "port" else JU.load_subset
    for name in _hdf5_names(ref.subsets_dir):
        mine = load(os.path.join((port if reader == "port" else ref)
                                 .subsets_dir, name))
        other = load(os.path.join((ref if reader == "port" else port)
                                  .subsets_dir, name))
        np.testing.assert_array_equal(mine[0], other[0])
        for a, b in zip(mine[1:], other[1:]):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)


def test_no_video_leakage_between_sets(prepared):
    port, _ = prepared
    videos = {}
    for name in _hdf5_names(port.subsets_dir):
        _, _, meta = TU.load_subset(os.path.join(port.subsets_dir, name))
        videos[name] = set(meta["video_id"])
    assert len(videos) == 3
    for a in videos:
        for b in videos:
            if a != b:
                assert not videos[a] & videos[b], (a, b)


def test_batches_match_the_jax_host_path(prepared):
    """The deterministic batches (validation, and the first train batch:
    the same shuffle) of both packages within 1e-6, from the port's
    subsets read by both."""
    port, ref = prepared
    jax_dm = JC.CarlaRecordedDataModule(
        datasets_dir="unused", outputs_dir=str(ref.outputs_dir),
        subsets_dir=port.subsets_dir, **COMMON)
    jax_dm.prepare_data()
    port.setup("fit")
    jax_dm.setup("fit")
    pairs = list(zip(port.val_batches(), jax_dm.val_batches()))
    pairs.append((next(port.train_batches()), next(jax_dm.train_batches())))
    assert len(pairs) > 1
    for (inputs, targets, meta), (j_in, j_targets, j_meta) in pairs:
        assert tuple(inputs.shape) == (4, CLIP_LEN, 26, 2)
        np.testing.assert_allclose(inputs.numpy(), np.asarray(j_in),
                                   rtol=0, atol=ATOL)
        assert set(targets) == set(j_targets)
        for k, v in j_targets.items():
            np.testing.assert_allclose(targets[k].numpy(), np.asarray(v),
                                       rtol=1e-7, atol=ATOL, err_msg=k)
        assert set(meta) == set(j_meta)
        for k, v in j_meta.items():
            np.testing.assert_array_equal(meta[k].numpy(), np.asarray(v))


def test_benchmark_tte_window_matches_jax(carla_csv, tmp_path):
    port, ref = (_make(carla_csv, tmp_path / side, side,
                       cls="CarlaBenchmarkDataModule", clip_offset=2,
                       tte=(2, 10)) for side in ("port", "jax"))
    _assert_same_subsets(port, ref)
    found = 0
    for name in _hdf5_names(port.subsets_dir):
        _, targets, meta = TU.load_subset(os.path.join(port.subsets_dir,
                                                       name))
        assert "crossing" in meta and "crossing" in targets
        # a clip ends within [crossing point - tte_hi, crossing point -
        # tte_lo]: each video crosses from frame N_FRAMES // 2 + 1
        event = N_FRAMES // 2 + 1
        assert np.all(meta["end_frame"] - 1 <= event - 2)
        assert np.all(meta["start_frame"] >= event - CLIP_LEN - 10)
        found += len(meta["end_frame"])
    assert found


def test_recorded_subset_has_the_prepared_layout(prepared):
    """``recorded_subset`` gives a prepared subset's fields, shapes (but
    the clip count) and dtypes."""
    port, _ = prepared
    proj, targets, meta = TU.load_subset(os.path.join(port.subsets_dir,
                                                      "train.hdf5"))
    n = 3
    made = TC.recorded_subset(
        proj[:n], (targets["relative_pose_loc"][:n],
                   targets["relative_pose_rot"][:n]),
        (targets["absolute_pose_loc"][:n],
         targets["absolute_pose_rot"][:n]))
    assert made[0].shape[1:] == proj.shape[1:]
    assert made[0].dtype == proj.dtype
    assert set(made[1]) == set(targets)
    for k, v in targets.items():
        got = np.asarray(made[1][k])
        assert got.shape == (n,) + v.shape[1:] and got.dtype == v.dtype, k
    assert set(made[2]) == set(meta)
    for k, v in meta.items():
        got = np.asarray(made[2][k])
        assert len(got) == n and got.dtype.kind == np.asarray(v).dtype.kind, k
    np.testing.assert_array_equal(made[1]["bboxes"], targets["bboxes"][:n])
    # the subset made in memory trains like the prepared one
    dm = TC.CarlaRecordedDataModule(device="cpu", outputs_dir="unused",
                                    **{**COMMON, "batch_size": n})
    dm.add_subset("train", *made)
    inputs, batch_targets, batch_meta = next(dm.train_batches())
    assert tuple(inputs.shape) == (n, CLIP_LEN, 26, 2)
    assert "projection_2d_transformed" in batch_targets
    assert set(batch_meta) == {"clip_id", "start_frame", "end_frame",
                               "clip_width", "clip_height",
                               "age_gender_idx"}


@pytest.mark.parametrize("fast_dev_run", [False, True])
def test_fast_dev_run_reads_the_same_prefix(tmp_path, fast_dev_run):
    path = tmp_path / "rows.csv"
    n = 18_500
    pd.DataFrame({"video": np.arange(n) // 100, "frame": np.arange(n),
                  "x": np.arange(n) * 0.5}).to_csv(path, index=False)

    def read(mixin, hdf5):
        cls = type("Rows", (mixin, hdf5), {})
        dm = cls(data_filepath=str(path), video_index=["video"],
                 pedestrian_index=[], clips_index=["frame"],
                 outputs_dir=str(tmp_path), fast_dev_run=fast_dev_run,
                 **({"device": "cpu"} if mixin is TP.PandasDataModuleMixin
                    else {}))
        return dm._read_data()

    from pedestrians_video_2_carla_torch.data.base.hdf5_datamodule import \
        Hdf5DataModule
    from pedestrians_video_2_carla_tpu.data.base.hdf5_datamodule import \
        Hdf5DataModule as JaxHdf5DataModule
    port = read(TP.PandasDataModuleMixin, Hdf5DataModule)
    ref = read(JP.PandasDataModuleMixin, JaxHdf5DataModule)
    assert len(port) == len(ref) == (18_000 if fast_dev_run else n)
    pd.testing.assert_frame_equal(port, ref)


def test_trainer_fits_two_steps(prepared, tmp_path):
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.base import \
        OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements.linear_ae import \
        LinearAE
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    port, _ = prepared
    port.setup("fit")
    flow = PoseLiftingFlow(
        LinearAE(generator=torch.Generator().manual_seed(0)),
        loss_modes=["loc_2d_3d"], projection_kernel="fused_train",
        movements_optimizer=OptimizerSettings(lr=1e-3), device="cpu")
    trainer = Trainer(flow, port, TrainerConfig(
        max_epochs=1, limit_train_batches=2, log_every_n_steps=1,
        logs_dir=str(tmp_path), run_name="cr", device="cpu"))
    state = trainer.fit()
    assert state.step == 2
    assert np.isfinite(trainer.evaluate("val")["val_loss/primary"])


def test_cli_trains_resident(carla_csv, tmp_path):
    results = modeling.main([
        "--data_module_name=CarlaRecorded", "--movements_model_name=LinearAE",
        f"--datasets_dir={carla_csv}", f"--outputs_dir={tmp_path / 'out'}",
        "--batch_size=4", f"--clip_length={CLIP_LEN}", "--clip_offset=4",
        "--val_set_frac=0.25", "--test_set_frac=0.25", "--max_epochs=2",
        "--loss_modes", "loc_2d_3d", "--projection_kernel=fused_train",
        "--log_every_n_steps=2", "--device_resident=true", "--device=cpu",
        f"--root_dir={tmp_path}", "--run_name=resident"])
    trainer, dm = results["trainer"], results["dm"]
    assert type(dm).__name__ == "CarlaRecordedDataModule"
    assert dm.device_resident and set(dm._resident) == {"train", "val",
                                                        "test"}
    assert trainer.runner is not None and not trainer.runner.graphs
    steps_per_epoch = dm.train_set_size // 4
    assert trainer.state.step == 2 * steps_per_epoch
    with open(tmp_path / "logs" / "pose_lifting" / "resident"
              / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    logged = [r["step"] for r in records if "lr-movements" in r]
    assert logged == list(range(2, 2 * steps_per_epoch + 1, 2))
    assert np.isfinite(results["val_metrics"]["val_loss/primary"])
