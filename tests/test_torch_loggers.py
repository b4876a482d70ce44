"""The port's loggers, renderers and video writer against the JAX
package's, and the CLI's logging, video and tracing flags, on the CPU.

* ``MetricsLogger`` and ``WandbOfflineLogger`` of both packages, fed the
  same scalars and hparams, write the same ``metrics.jsonl``,
  ``hparams.json``, ``wandb-summary.json``, ``wandb-history.jsonl`` (the
  wall-clock fields aside) and ``config.yaml`` (as ``yaml.safe_load``
  reads it; the port writes it without PyYAML).
* ``PointsRenderer`` and ``SourceVideosRenderer`` frames equal the JAX
  package's bit for bit, and so do the writer's merged clips, array for
  array, before they are encoded (the mp4 bytes are not compared).
* The CLI with ``--renderers`` writes training and validation mp4s under
  the run's ``videos/``; ``--profile`` writes a trace and prints timings;
  the renderers that need CARLA raise at argument time. ``smpl`` draws
  the JAX writer's arrays and the CLI writes the JAX CLI's videos with it.
"""
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from pedestrians_video_2_carla_tpu.loggers import \
    pedestrian_writer as JWriter
from pedestrians_video_2_carla_tpu.renderers.points_renderer import \
    PointsRenderer as JPointsRenderer
from pedestrians_video_2_carla_tpu.renderers.source_videos_renderer import \
    SourceVideosRenderer as JSourceVideosRenderer
from pedestrians_video_2_carla_tpu.skeletons.carla import \
    CARLA_SKELETON as J_CARLA
from pedestrians_video_2_carla_tpu.training import loggers as JL

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.loggers import \
    pedestrian_writer as TWriter
from pedestrians_video_2_carla_torch.renderers.points_renderer import \
    PointsRenderer
from pedestrians_video_2_carla_torch.renderers.source_videos_renderer \
    import SourceVideosRenderer
from pedestrians_video_2_carla_torch.skeletons.carla import CARLA_SKELETON
from pedestrians_video_2_carla_torch.training import loggers as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HPARAMS = {"batch_size": 16, "lr": 1e-3, "tiny": 1e-8, "big": 1.5e20,
           "name": "Carla2D3D", "flag": True, "none": None,
           "nodes": ["CARLA_SKELETON", 26], "nested": {"a": [1.0, -2.5]},
           "object": object, "unicode": "café \"q\"\n"}
SCALARS = [(1, {"train_loss/primary": 0.5, "lr-movements": 1e-4,
                "skipme": "str"}),
           (2, {"train_loss/primary": 0.25, "epoch": 0}),
           (-1, {"test_loss/primary": 0.125})]


def _records(path, drop):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in drop}
                for line in f]


def _feed(logger):
    logger.log_hparams(HPARAMS)
    for step, scalars in SCALARS:
        logger.log_scalars(step, scalars)
    logger.log_hparams({"initial_MPJPE": 0.75})
    logger.close()


def _run_files(root):
    (files,) = glob.glob(os.path.join(root, "wandb", "offline-run-*-rt",
                                      "files"))
    return files


@pytest.mark.parametrize("kind", ["MetricsLogger", "WandbOfflineLogger"])
def test_loggers_write_the_jax_files(kind, tmp_path):
    kwargs = {"run_id": "rt", "argv": ["prog", "--flag"]} \
        if kind == "WandbOfflineLogger" else {}
    _feed(getattr(TL, kind)(str(tmp_path / "port"), **kwargs))
    _feed(getattr(JL, kind)(str(tmp_path / "jax"), **kwargs))
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert _records(port / "metrics.jsonl", {"time"}) \
        == _records(ref / "metrics.jsonl", {"time"})
    with open(port / "hparams.json") as f, open(ref / "hparams.json") as g:
        assert json.load(f) == json.load(g)
    assert os.path.isdir(port / "tb") == os.path.isdir(ref / "tb")
    if kind == "MetricsLogger":
        return
    pf, rf = _run_files(str(port)), _run_files(str(ref))
    assert _records(os.path.join(pf, "wandb-history.jsonl"),
                    {"_timestamp"}) \
        == _records(os.path.join(rf, "wandb-history.jsonl"), {"_timestamp"})
    summaries = []
    for files in (pf, rf):
        with open(os.path.join(files, "wandb-summary.json")) as f:
            summaries.append({k: v for k, v in json.load(f).items()
                              if k != "_timestamp"})
    assert summaries[0] == summaries[1]
    configs = []
    for files in (pf, rf):
        with open(os.path.join(files, "config.yaml")) as f:
            configs.append(yaml.safe_load(f))
    assert configs[0] == configs[1]
    assert configs[0]["tiny"] == {"value": 1e-8}
    metas = []
    for files in (pf, rf):
        with open(os.path.join(files, "wandb-metadata.json")) as f:
            metas.append({k: v for k, v in json.load(f).items()
                          if k != "startedAt"})
    assert metas[0] == metas[1]


def test_wandb_run_directory_replays_as_the_jax_one(tmp_path):
    """``tools/wandb_replay.py`` (which reads ``config.yaml`` with PyYAML)
    finds and validates the port's run directory as the JAX package's."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import wandb_replay
    finally:
        sys.path.pop(0)
    stats = []
    for name, module in (("port", TL), ("jax", JL)):
        _feed(module.WandbOfflineLogger(str(tmp_path / name), run_id="rt"))
        (run,) = wandb_replay.discover_run_dirs(str(tmp_path / name))
        stats.append(wandb_replay.replay_run(run, dry_run=True))
    assert stats[0] == stats[1]


TB_NO_TENSORFLOW = """
import shutil, sys, threading, time
sys.modules["tensorflow"] = None   # TensorBoard's own file system
from pedestrians_video_2_carla_torch.training.loggers import MetricsLogger
errors = []
threading.excepthook = errors.append
for i in range(5):
    log_dir = sys.argv[1] + f"/run{i}"
    logger = MetricsLogger(log_dir)
    for step in range(20):
        logger.log_scalars(step, {f"m{k}": float(k) for k in range(12)})
    shutil.rmtree(log_dir)
time.sleep(0.5)
assert not errors, [str(e.exc_value) for e in errors]
"""


def test_logger_leaves_no_tensorboard_write_pending(tmp_path):
    """When ``log_scalars`` returns, TensorBoard's writer thread has
    written everything: the caller may remove the log directory at once
    (without TensorFlow the thread appends by path, and a queued write
    would make the file anew in a removed directory)."""
    import subprocess
    out = subprocess.run([sys.executable, "-c", TB_NO_TENSORFLOW,
                          str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_disabled_logger_writes_nothing(tmp_path):
    logger = TL.WandbOfflineLogger(str(tmp_path / "off"), enabled=False)
    _feed(logger)
    assert not (tmp_path / "off").exists()


def _points(rng, B=2, L=3, missing=True):
    pts = rng.uniform(20, 580, size=(B, L, 26, 2)).astype(np.float32)
    if missing:
        pts[0, 1, [3, 7, 20]] = 0.0
    return pts


def test_points_renderer_frames_equal_jax():
    pts = _points(np.random.default_rng(0))
    for size in ((800, 600), (64, 48)):
        got = list(PointsRenderer(CARLA_SKELETON, image_size=size)
                   .render(pts))
        want = list(JPointsRenderer(J_CARLA, image_size=size).render(pts))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert got[0].any()


def test_denormalize_from_projection_equals_jax():
    """The writer's denormalization: normalized 2D poses onto each clip's
    reference projection, as the JAX function places them."""
    from pedestrians_video_2_carla_tpu.ops import reference_skeletons as JRS

    from pedestrians_video_2_carla_torch.ops import reference_skeletons as TRS
    rng = np.random.default_rng(4)
    frames = rng.normal(0, 0.3, size=(4, 5, 26, 2)).astype(np.float32)
    agi = np.asarray([0, 1, 2, 3])
    got = TRS.denormalize_from_projection(torch.as_tensor(frames),
                                          torch.as_tensor(agi)).numpy()
    want = np.asarray(JRS.denormalize_from_projection(frames, agi))
    assert got.shape == want.shape == frames.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def _write_video(path, frames=6, size=(96, 64)):
    import cv2
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             30.0, size)
    rng = np.random.default_rng(3)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (size[1], size[0], 3), np.uint8))
    writer.release()


def _writer_batch(rng, B=3, L=4):
    inputs = rng.normal(0, 0.3, size=(B, L, 26, 2)).astype(np.float32)
    inputs[1, 2, 5] = 0.0
    targets = {"projection_2d": rng.uniform(10, 60, (B, L, 26, 2)).astype(
        np.float32),
        "bboxes": np.tile(np.asarray([[5, 5], [40, 50]], np.float32),
                          (B, L, 1, 1)),
        "crossing": np.asarray([1, 0, 1])}
    projections = {"projection_2d_transformed": rng.normal(
        0, 0.3, size=(B, L, 26, 2)).astype(np.float32),
        "projection_2d": None}
    meta = {"age_gender_idx": np.asarray([0, 3, 1]),
            "video_id": np.asarray(["clip", "clip", "missing"]),
            "start_frame": np.asarray([0, 1, 0]),
            "end_frame": np.asarray([L, L + 1, L])}
    return inputs, targets, projections, meta


@pytest.mark.parametrize("merging", ["square", "horizontal", "vertical"])
def test_writer_merged_clips_equal_jax(merging, tmp_path):
    _write_video(tmp_path / "clip.mp4")
    renderers = ["zeros", "input_points", "target_points",
                 "projection_points", "source_videos"]
    batch = _writer_batch(np.random.default_rng(1))
    clips = {}
    for name, module in (("port", TWriter), ("jax", JWriter)):
        seen = []
        writer = module.PedestrianWriter(
            str(tmp_path / name), renderers=renderers, max_videos=2,
            merging_method=merging, source_videos_dir=str(tmp_path),
            overlay_classes=True)
        paths = writer.log_videos(
            *batch, step=3, stage="val", force=True,
            vid_callback=lambda v, i, fps, stage, meta: seen.append(v))
        assert [os.path.basename(p) for p in paths] == [
            f"val-step=000003-batch=0000-clip={i:02d}.mp4" for i in (0, 1)]
        assert all(os.path.getsize(p) > 0 for p in paths)
        clips[name] = seen
    assert len(clips["port"]) == len(clips["jax"]) == 2
    for got, want in zip(clips["port"], clips["jax"]):
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_source_videos_renderer_equals_jax(tmp_path):
    """The video's frames with each overlay, and black frames for a clip
    whose video does not read."""
    _write_video(tmp_path / "clip.mp4")
    inputs, targets, _, meta = _writer_batch(np.random.default_rng(2))
    outputs = _points(np.random.default_rng(4), B=3, L=4)
    for switches in ({}, {"overlay_skeletons": False},
                     {"overlay_bboxes": False, "overlay_classes": True}):
        got, want = (list(cls(source_videos_dir=str(tmp_path), **switches)
                          .render(meta=meta, targets=targets,
                                  input_points=targets["projection_2d"],
                                  output_points=outputs))
                     for cls in (SourceVideosRenderer, JSourceVideosRenderer))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert not got[2].any() and got[0].any()


def test_writer_refuses_renderers_it_does_not_have(tmp_path):
    for name in ("carla", "source_carla"):
        with pytest.raises(NotImplementedError, match="M8"):
            TWriter.PedestrianWriter(str(tmp_path), renderers=[name])
    # smpl is ported: without a body model file it draws the targets'
    # projections on the SMPL skeleton, as the JAX writer does
    batch = _writer_batch(np.random.default_rng(5))
    clips = [[], []]
    for seen, (name, module) in zip(clips, (("port", TWriter),
                                            ("jax", JWriter))):
        module.PedestrianWriter(
            str(tmp_path / name), renderers=["smpl"], max_videos=2
        ).log_videos(*batch, stage="val", force=True,
                     vid_callback=lambda v, *a: seen.append(v))
    assert len(clips[0]) == len(clips[1]) == 2
    for got, want in zip(*clips):
        np.testing.assert_array_equal(got, want)
        assert got.any()
    with pytest.raises(ValueError, match="unknown renderer"):
        TWriter.PedestrianWriter(str(tmp_path), renderers=["points"])
    assert TWriter.PedestrianWriter(
        str(tmp_path), renderers=["none"]).log_videos(
        np.zeros((1, 1, 26, 2)), {}, {}, {}) == []


CLI = ["--flow=pose_lifting", "--movements_model_name=Linear",
       "--loss_modes", "loc_2d", "--batch_size=2", "--clip_length=3",
       "--max_epochs=1", "--limit_train_batches=2", "--val_set_size=2",
       "--log_every_n_steps=1", "--device=cpu", "--run_name=r"]


def test_cli_renderers_write_mp4s(tmp_path):
    """As the JAX test ``tests/flows/test_modeling.py``'s
    ``test_renderers_write_mp4s``: training and validation videos."""
    results = modeling.main(CLI + [
        f"--root_dir={tmp_path}", "--renderers", "input_points",
        "projection_points", "--max_videos", "2",
        "--video_saving_frequency_reduction", "1"])
    videos = glob.glob(os.path.join(results["trainer"].log_dir, "videos",
                                    "*.mp4"))
    assert videos and all(os.path.getsize(v) > 0 for v in videos)
    assert {os.path.basename(v).split("-")[0] for v in videos} \
        == {"train", "val"}


def test_cli_refuses_unported_renderers_before_building(tmp_path):
    for name, error in (("carla", NotImplementedError),
                        ("points", ValueError)):
        with pytest.raises(error):
            modeling.main(CLI + [f"--root_dir={tmp_path}", "--renderers",
                                 name])
    assert not (tmp_path / "logs").exists()
    # --renderers smpl runs, and writes the videos the JAX CLI writes
    from pedestrians_video_2_carla_tpu import modeling as jmodeling
    argv = CLI + ["--renderers", "smpl", "--max_videos", "1",
                  "--video_saving_frequency_reduction", "1"]
    names = []
    for side, main, drop in (("port", modeling.main, []),
                             ("jax", jmodeling.main, ["--device=cpu"])):
        results = main([a for a in argv if a not in drop]
                       + [f"--root_dir={tmp_path / side}"])
        videos = glob.glob(os.path.join(str(tmp_path / side), "logs",
                                        "pose_lifting", "r", "videos",
                                        "*.mp4"))
        assert videos and all(os.path.getsize(v) > 0 for v in videos)
        assert results["val_metrics"]
        names.append(sorted(os.path.basename(v) for v in videos))
    assert names[0] == names[1]


def test_cli_profile_writes_a_trace_and_prints_timings(tmp_path, capsys):
    from pedestrians_video_2_carla_torch.utils import profiling
    profiling.reset_timings()
    results = modeling.main(CLI + [f"--root_dir={tmp_path}", "--profile",
                                   "--logger", "wandb", "-v"])
    path = os.path.join(results["trainer"].log_dir, "trace", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("Linear" in e.get("name", "") or "addmm" in e.get("name", "")
               for e in events)
    assert "Trainer.fit:" in capsys.readouterr().out
    assert profiling.get_timings()["Trainer.fit"]["calls"] == 1
    assert glob.glob(os.path.join(results["trainer"].log_dir, "wandb",
                                  "offline-run-*", "files", "config.yaml"))


def test_profiling_helpers(capsys):
    from pedestrians_video_2_carla_torch.utils import profiling as P

    P.reset_timings()

    @P.timing
    def work():
        with P.annotate("inner"):
            return torch.ones(2).sum()

    with P.timed("region"):
        work()
        work()
    timings = P.get_timings()
    assert timings["region"]["calls"] == 1
    assert timings[f"{__name__}.test_profiling_helpers.<locals>.work"][
        "calls"] == 2
    P.print_timing()
    assert "region:" in capsys.readouterr().out
    P.reset_timings()
    assert P.get_timings() == {}


def test_trainer_skips_the_fit_start_pass(tmp_path):
    results = modeling.main(CLI + [
        f"--root_dir={tmp_path}", "--flow=autoencoder",
        "--movements_output_type=pose_2d", "--max_epochs=2",
        "--check_val_every_n_epoch=2", "--skip_initial_metrics", "true"])
    log_dir = results["trainer"].log_dir
    with open(os.path.join(log_dir, "hparams.json")) as f:
        hparams = json.load(f)
    assert not any(k.startswith("initial_") for k in hparams)
    assert "params/movements" in hparams
    epochs = [r for r in _records(os.path.join(log_dir, "metrics.jsonl"),
                                  {"time"}) if "epoch" in r]
    assert [("val_loss/primary" in r) for r in epochs] == [False, True]
