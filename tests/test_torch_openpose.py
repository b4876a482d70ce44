"""Port parity for BASELINE config 3's data path on real-format labels, on
the CPU: JAAD- and PIE-format annotation CSVs and OpenPose BODY_25 keypoint
JSONs (and a PedestrianActionBenchmark pose pickle), written by the test
from the port's reference projections, prepared by both packages'
datamodules into separate output directories.

Held equal: every dataset and attribute of the HDF5 subsets (``projection_2d``,
``targets/*``, ``meta/*`` with their label encodings), the settings digest,
``dparams.yaml`` (set sizes, class labels and counts); each package reads
the other's subsets to the same arrays; the validation batches of a
deterministic configuration agree to 1e-5 (rtol 1e-6 beside it for pixel
values). Also: the IoU matching, the strong-points filter,
``label_frames``, ``balance_classes``, the benchmark's time-to-event
window, ``device_resident`` batches equal to the streamed ones, and a
2-step CLI fit on the CPU.
"""
import json
import os
import pickle

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from pedestrians_video_2_carla_tpu.data.base import hdf5_utils as JU
from pedestrians_video_2_carla_tpu.data.openpose import datamodules as JD
from pedestrians_video_2_carla_tpu.skeletons import \
    CARLA_SKELETON as J_CARLA

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.data.base import hdf5_utils as TU
from pedestrians_video_2_carla_torch.data.openpose import datamodules as TD
from pedestrians_video_2_carla_torch.ops.reference_skeletons import \
    reference_projections
from pedestrians_video_2_carla_torch.skeletons import (BODY_25_SKELETON,
                                                       CARLA_SKELETON,
                                                       COCO_SKELETON,
                                                       map_pose)
from .torch_threads import limit_torch_threads

limit_torch_threads()

N_VIDEOS, N_FRAMES, CLIP_LEN, CLIP_OFFSET = 4, 24, 6, 3
CROSSING_POINT = N_FRAMES - 4
#: the frame of video 3 whose only detection is the far-away one; the
#: video whose pedestrian crosses in frames LATE_FRAMES alone; video 3's
#: pedestrian crosses from frame LAST_CROSSING on (so that each split
#: holds both classes), video 1's throughout
BOGUS_ONLY, LATE_VIDEO, LATE_FRAMES, LAST_CROSSING = (3, 5), 2, (14, 16), 18
COMMON = dict(batch_size=4, clip_length=CLIP_LEN, clip_offset=CLIP_OFFSET,
              val_set_frac=0.25, test_set_frac=0.25)
ATOL, RTOL = 1e-5, 1e-6
#: 21 of BODY_25's 25 joints have a CARLA bone: a clip whose every frame is
#: detected keeps 0.84 of its points, one with an undetected frame 0.7
STRONG = 0.8


def _write_video(op_dir, video_id, b25, rng, vid):
    """One video's keypoint JSONs and annotation rows."""
    os.makedirs(op_dir, exist_ok=True)
    rows = []
    present = np.any(b25 != 0, axis=-1, keepdims=True)
    for frame in range(N_FRAMES):
        # the joints CARLA has no bone for are undetected: (0, 0, 0)
        kp = np.where(present, b25 + rng.normal(scale=2.0, size=b25.shape),
                      0.0)
        kp3 = np.concatenate([kp, 0.9 * present], axis=-1)
        # a second detection far away: the IoU matching must reject it
        bogus = kp3.copy()
        bogus[:, 0] += 300 * present[:, 0]
        people = [bogus, kp3] if (vid, frame) != BOGUS_ONLY else [bogus]
        with open(op_dir / f"{video_id}_{frame:012d}_keypoints.json",
                  "w") as f:
            json.dump({"people": [{"pose_keypoints_2d": p.reshape(-1)
                                   .tolist()} for p in people]}, f)
        x1, y1 = kp[present[:, 0]].min(axis=0)
        x2, y2 = kp[present[:, 0]].max(axis=0)
        crossing = vid == 1 or (vid == 3 and frame >= LAST_CROSSING) or (
            vid == LATE_VIDEO and LATE_FRAMES[0] <= frame <= LATE_FRAMES[1])
        rows.append({
            "beh": vid != 0 or frame % 2 == 0, "video": video_id,
            "frame": frame, "x1": x1, "y1": y1, "x2": x2, "y2": y2,
            "id": f"0_{vid}_1b", "gender": ("male", "female")[vid % 2],
            "age": ("adult", "child", "senior", "adult")[vid],
            "crossing": "1" if crossing else "0",
            "crossing_point": CROSSING_POINT if vid != 3 else -1,
            "video_width": 800, "video_height": 600})
    return rows


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    ref = reference_projections()[0, :, :2]              # (26, 2) px
    b25 = map_pose(ref[None], CARLA_SKELETON, BODY_25_SKELETON)[0]
    coco = map_pose(ref[None], CARLA_SKELETON, COCO_SKELETON)[0]
    rng = np.random.default_rng(1)
    jaad_rows, pie_rows = [], []
    for vid in range(N_VIDEOS):
        video_id = f"video_{vid:04d}"
        jaad_rows += _write_video(root / "JAAD" / "openpose" / video_id,
                                  video_id, b25, rng, vid)
        set_name = f"set0{vid % 2 + 1}"
        pie_rows += [{**r, "set_name": set_name} for r in _write_video(
            root / "PIE" / "openpose" / set_name / video_id, video_id, b25,
            rng, vid)]
    pd.DataFrame(jaad_rows).to_csv(root / "JAAD" / "annotations.csv",
                                   index=False)
    pd.DataFrame(pie_rows).to_csv(root / "PIE" / "annotations.csv",
                                  index=False)
    # the benchmark's COCO pose pickle: {video: {pedestrian: {frame: xy}}}
    poses = {f"video_{v:04d}": {f"0_{v}_1b": {
        f"{f:05d}": (coco + v + 0.5 * f).reshape(-1).tolist()
        for f in range(N_FRAMES)}} for v in range(N_VIDEOS)}
    os.makedirs(root / "poses")
    with open(root / "poses" / "jaad_all.pkl", "wb") as f:
        pickle.dump(poses, f)
    return str(root)


def _prepare(tmp_path, datasets, name, side, **kwargs):
    """One package's datamodule, prepared under ``tmp_path / side``."""
    if side == "port":
        kwargs.setdefault("device", "cpu")
    dm = getattr(TD if side == "port" else JD, name)(
        datasets_dir=datasets, outputs_dir=str(tmp_path / side),
        **{**COMMON, **kwargs})
    dm.prepare_data()
    return dm


def _datasets(path):
    """Every dataset of an HDF5 file: name -> (array, attributes)."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, (
            obj[()], {k: np.asarray(v) for k, v in obj.attrs.items()}))
            if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_files(port, ref):
    assert port.settings_digest == ref.settings_digest
    assert port.settings == ref.settings
    assert port._set_size == ref._set_size and port._set_size
    assert port.class_labels == ref.class_labels
    assert port._class_counts == ref._class_counts
    with open(os.path.join(port.subsets_dir, "dparams.yaml")) as f, \
            open(os.path.join(ref.subsets_dir, "dparams.yaml")) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    names = sorted(n for n in os.listdir(ref.subsets_dir)
                   if n.endswith(".hdf5"))
    assert names == sorted(n for n in os.listdir(port.subsets_dir)
                           if n.endswith(".hdf5"))
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


@pytest.fixture(scope="module")
def jaad(tmp_path_factory, datasets):
    """The JAAD module of both packages, prepared (the default settings)."""
    tmp = tmp_path_factory.mktemp("jaad")
    return (_prepare(tmp, datasets, "JAADOpenPoseDataModule", "port"),
            _prepare(tmp, datasets, "JAADOpenPoseDataModule", "jax"))


def test_jaad_subsets_match_jax(jaad):
    port, ref = jaad
    _assert_same_files(port, ref)
    assert port.class_labels == {"crossing": ["not-crossing", "crossing"]}
    # beh filtering keeps every other frame of video 0: its runs of one
    # frame make no clips, so three videos are split 1 / 1 / 1
    assert port._set_size == {"train": 7, "val": 7, "test": 7}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_subsets(jaad, writer):
    port, ref = jaad
    root = (port if writer == "port" else ref).subsets_dir
    for name in ("train", "val", "test"):
        path = os.path.join(root, f"{name}.hdf5")
        got, want = TU.load_subset(path), JU.load_subset(path)
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_val_batches_match_jax(tmp_path, datasets):
    port = _prepare(tmp_path, datasets, "JAADOpenPoseDataModule", "port",
                    input_nodes=CARLA_SKELETON)
    ref = _prepare(tmp_path, datasets, "JAADOpenPoseDataModule", "jax",
                   input_nodes=J_CARLA)
    for dm in (port, ref):
        dm.setup("fit")
    got, want = list(port.val_batches()), list(ref.val_batches())
    # 7 clips in batches of 4: the last batch wraps around
    assert len(got) == len(want) == 2
    for (inputs, targets, meta), (j_in, j_targets, j_meta) in zip(got, want):
        assert tuple(inputs.shape) == (4, CLIP_LEN, len(CARLA_SKELETON), 2)
        np.testing.assert_allclose(inputs.numpy(), np.asarray(j_in),
                                   rtol=RTOL, atol=ATOL)
        assert set(targets) == set(j_targets)
        for k, v in j_targets.items():
            np.testing.assert_allclose(targets[k].numpy(), np.asarray(v),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        assert set(meta) == set(j_meta)
        for k, v in j_meta.items():
            np.testing.assert_array_equal(meta[k].numpy(), np.asarray(v))
    # the train stream shuffles the same clips in the same order
    inputs, targets, _ = next(port.train_batches())
    j_in, j_targets, _ = next(ref.train_batches())
    np.testing.assert_array_equal(targets["crossing"].numpy(),
                                  np.asarray(j_targets["crossing"]))
    np.testing.assert_allclose(inputs.numpy(), np.asarray(j_in), rtol=RTOL,
                               atol=ATOL)


def test_iou_matching_picks_the_right_candidate(jaad):
    port, _ = jaad
    projection_2d, _, meta = TU.load_subset(
        os.path.join(port.subsets_dir, "train.hdf5"))
    detected = projection_2d[..., 0][np.any(projection_2d[..., :2] != 0, -1)]
    # the far-away candidate sits at x + 300: never taken
    assert detected.max() < 700
    # a frame whose only candidate is that one is left undetected
    frames = []
    for name in ("train", "val", "test"):
        p, _, m = TU.load_subset(os.path.join(port.subsets_dir,
                                              f"{name}.hdf5"))
        for clip, video, start in zip(p, m["video_id"], m["start_frame"]):
            if video == f"video_{BOGUS_ONLY[0]:04d}" \
                    and start <= BOGUS_ONLY[1] < start + CLIP_LEN:
                frames.append(clip[BOGUS_ONLY[1] - start])
    assert frames and all((f == 0).all() for f in frames)


def test_strong_points_filter_matches_jax(tmp_path, datasets, jaad):
    port = _prepare(tmp_path, datasets, "JAADOpenPoseDataModule", "port",
                    strong_points=STRONG)
    ref = _prepare(tmp_path, datasets, "JAADOpenPoseDataModule", "jax",
                   strong_points=STRONG)
    _assert_same_files(port, ref)
    assert port.settings_digest != jaad[0].settings_digest
    # the clips over the undetected frame are gone, no other
    assert sum(port._set_size.values()) == sum(jaad[0]._set_size.values()) - 2


def test_label_frames_matches_jax(tmp_path, datasets, jaad):
    kwargs = dict(label_frames=0.5, sample_type="all")
    port = _prepare(tmp_path, datasets, "JAADOpenPoseDataModule", "port",
                    **kwargs)
    ref = _prepare(tmp_path, datasets, "JAADOpenPoseDataModule", "jax",
                   **kwargs)
    _assert_same_files(port, ref)
    last = _prepare(tmp_path / "last", datasets, "JAADOpenPoseDataModule",
                    "port", sample_type="all")

    def labels(dm):
        out = {}
        for name in ("train", "val", "test"):
            _, t, m = TU.load_subset(os.path.join(dm.subsets_dir,
                                                  f"{name}.hdf5"))
            out.update({(v, s): int(c) for v, s, c in zip(
                m["video_id"], m["start_frame"], t["crossing"])})
        return out
    half, at_end = labels(port), labels(last)
    assert set(half) == set(at_end)
    late = f"video_{LATE_VIDEO:04d}"
    lo, hi = LATE_FRAMES
    for (video, start), label in half.items():
        end = start + CLIP_LEN - 1
        if video != late:
            assert label == at_end[(video, start)]
            continue
        # the last frame, against any frame of the clip's last half
        assert at_end[(video, start)] == int(lo <= end <= hi)
        assert label == int(max(end - CLIP_LEN // 2 + 1, lo) <= min(end, hi))
    assert half != at_end


def test_balance_classes_matches_jax(tmp_path, datasets):
    kwargs = dict(balance_classes=True, sample_type="all", label_frames=0.5)
    port = _prepare(tmp_path, datasets, "JAADOpenPoseDataModule", "port",
                    **kwargs)
    ref = _prepare(tmp_path, datasets, "JAADOpenPoseDataModule", "jax",
                   **kwargs)
    _assert_same_files(port, ref)
    counts = port._class_counts["train"]["crossing"]
    assert counts["crossing"] == counts["not-crossing"] > 0


def test_pie_subsets_match_jax(tmp_path, datasets):
    port = _prepare(tmp_path, datasets, "PIEOpenPoseDataModule", "port")
    ref = _prepare(tmp_path, datasets, "PIEOpenPoseDataModule", "jax")
    _assert_same_files(port, ref)
    _, _, meta = TU.load_subset(os.path.join(port.subsets_dir, "train.hdf5"))
    assert set(meta["set_name"]) <= {"set01", "set02"} and len(meta["set_name"])


@pytest.mark.parametrize("pose_data", ["pickle", "json"])
def test_benchmark_window_matches_jax(tmp_path, datasets, pose_data):
    kwargs = dict(tte=(1, 4), pose_data=pose_data, pose_pickles_dir="poses",
                  val_set_frac=0.25, test_set_frac=0.25, batch_size=2)
    port = TD.JAADBenchmarkDataModule(
        datasets_dir=datasets, outputs_dir=str(tmp_path / "port"),
        clip_length=CLIP_LEN, device="cpu", **kwargs)
    ref = JD.JAADBenchmarkDataModule(
        datasets_dir=datasets, outputs_dir=str(tmp_path / "jax"),
        clip_length=CLIP_LEN, **kwargs)
    for dm in (port, ref):
        dm.prepare_data()
    _assert_same_files(port, ref)
    assert port.data_nodes is (COCO_SKELETON if pose_data == "pickle"
                               else BODY_25_SKELETON)
    for name in ("train", "val", "test"):
        path = os.path.join(port.subsets_dir, f"{name}.hdf5")
        if not os.path.exists(path):
            continue
        _, _, meta = TU.load_subset(path)
        for video, start, end in zip(meta["video_id"], meta["start_frame"],
                                     meta["end_frame"]):
            # the clip lies in [event - clip_length - tte_hi,
            # event - tte_lo]; a video that never crosses has its event 3
            # frames before its last
            event = CROSSING_POINT if video != "video_0003" \
                else N_FRAMES - 1 - 3
            assert start >= event - CLIP_LEN - 4 and end - 1 <= event - 1


def test_device_resident_names_m6(jaad, datasets, tmp_path):
    """M6 ported ``device_resident``: the JAAD subsets kept on the device
    give the streamed batches, bit for bit, also where flip and rotation
    draw in training."""
    port, _ = jaad
    streamed, resident = (TD.JAADOpenPoseDataModule(
        datasets_dir=datasets, outputs_dir=port.outputs_dir,
        augment_flip=True, augment_rotate=True, device_resident=flag,
        device="cpu", **COMMON) for flag in (False, True))
    for dm in (streamed, resident):
        dm.prepare_data()
        dm.setup()
    assert set(resident._resident) == {"train", "val", "test"}
    for a, b in zip(list(streamed.train_batches(5))
                    + list(streamed.val_batches()),
                    list(resident.train_batches(5))
                    + list(resident.val_batches())):
        assert torch.equal(a[0], b[0])
        assert set(a[1]) == set(b[1])
        assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
        assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def test_in_memory_subsets_batch_like_loaded_ones(jaad, tmp_path, datasets):
    """``add_subset`` takes plain numpy arrays: a datamodule fed the loaded
    arrays by hand gives the batches ``setup`` gives."""
    port, _ = jaad
    loaded = _prepare(tmp_path, datasets, "JAADOpenPoseDataModule", "port")
    loaded.setup()
    fed = TD.Hdf5DataModule(data_nodes=BODY_25_SKELETON, device="cpu",
                            outputs_dir=str(tmp_path / "fed"), **COMMON)
    for name in ("train", "val", "test"):
        fed.add_subset(name, *TU.load_subset(
            os.path.join(port.subsets_dir, f"{name}.hdf5")))
    assert fed.val_set_size == loaded.val_set_size == 7
    for a, b in zip(fed.val_batches(), loaded.val_batches()):
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(a[1][k], b[1][k]) for k in b[1])


def test_cli_trains_gconvgru_on_jaad(tmp_path, datasets):
    results = modeling.main([
        "--flow=classification", "--data_module_name=JAADOpenPose",
        "--classification_model_name=GConvGRU", "--hidden_size=8",
        f"--datasets_dir={datasets}", f"--outputs_dir={tmp_path / 'out'}",
        "--batch_size=2", f"--clip_length={CLIP_LEN}",
        f"--clip_offset={CLIP_OFFSET}", "--limit_train_batches=2",
        "--augment_flip=true", "--augment_rotate=true", "--noise=gaussian",
        "--missing_joint_probabilities_24=0.5", "--log_every_n_steps=1",
        "--device=cpu", f"--root_dir={tmp_path}", "--run_name=jaad"])
    dm, flow = results["dm"], results["flow"]
    assert type(dm).__name__ == "JAADOpenPoseDataModule"
    # the JAX rule: the model reads the data's skeleton unless
    # --input_nodes names another
    assert flow.classification_model.input_nodes is BODY_25_SKELETON
    assert dm.preprocessing.augment_flip == 0.5
    assert dm.preprocessing.missing_joint_probabilities == (0.0,) * 24 + (0.5,)
    run = tmp_path / "logs" / "classification" / "jaad"
    with open(run / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "lr-classification" in r]
    assert len(steps) == 2
    assert all(np.isfinite(r["train_loss/primary"]) for r in steps)
    assert np.isfinite(results["val_metrics"]["val_loss/primary"])
    with open(run / "hparams.json") as f:
        hparams = json.load(f)
    assert "initial_Accuracy" in hparams
    assert hparams["settings_digest"] == dm.settings_digest
    assert os.listdir(run / "plots")       # the confusion matrix and curves


def test_cli_trains_on_the_jax_packages_subsets_dir(jaad, tmp_path):
    """``--subsets_dir``: the port trains on subsets that the JAX package
    prepared (through SubsetsDataModule, whichever datamodule wrote
    them)."""
    _, ref = jaad
    results = modeling.main([
        "--flow=classification", "--data_module_name=JAADOpenPose",
        "--classification_model_name=GCNBestPaper",
        f"--subsets_dir={ref.subsets_dir}", "--input_nodes=CARLA_SKELETON",
        "--batch_size=2", f"--clip_length={CLIP_LEN}",
        "--limit_train_batches=2", "--device=cpu", f"--root_dir={tmp_path}",
        "--run_name=subsets"])
    dm = results["dm"]
    assert type(dm).__name__ == "SubsetsDataModule"
    assert dm.subsets_dir == ref.subsets_dir
    assert dm._set_size == ref._set_size
    assert np.isfinite(results["val_metrics"]["val_loss/primary"])
