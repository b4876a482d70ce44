"""Port parity for the pose-estimation slice's weight importers, video
data modules and CLI, on the CPU (the models and the flow are in
``tests/test_torch_pose_estimation.py``, whose helpers these share).

* ``import_torchvision_resnet`` and ``graft_resnet_backbone`` from one
  synthetic torchvision state dict against the JAX importers: the
  4-channel conv1 and the ResNet-101 detection; the trainer's
  ``restore_pretrained_backbone`` on a file.
* ``CarlaRecordedVideoDataModule``'s batches from mp4s the test writes
  with cv2, against the JAX data module's: frames, crops and heatmap
  targets; the mixin's helpers; a batch dropped whole where a video does
  not decode; ``JAADUniPose``'s extraction and the registry.
* ``visualize_heatmaps`` against the JAX strip, a CLI fit of each model on
  the synthesized set (UniPoseLSTM with ``--loss_modes heatmaps``) and
  ``--pretrained_backbone_path`` through the CLI. The models' "resnet50"
  is cut to one block a stage here (``small_backbone``).
"""
import json
import os

import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.data.base import video_mixin as JV
from pedestrians_video_2_carla_tpu.data.carla import carla_recorded as JC
from pedestrians_video_2_carla_tpu.models import torch_import as JT
from pedestrians_video_2_carla_tpu.models.backbones import resnet as JR
from pedestrians_video_2_carla_tpu.utils import visualize_heatmaps as JVis

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.data import discover
from pedestrians_video_2_carla_torch.data.base import video_mixin as TV
from pedestrians_video_2_carla_torch.data.carla import carla_recorded as TC
from pedestrians_video_2_carla_torch.data.unipose.jaad_unipose import \
    JAADUniPoseDataModule
from pedestrians_video_2_carla_torch.models import torch_import as TT
from pedestrians_video_2_carla_torch.models.backbones import resnet as TR
from pedestrians_video_2_carla_torch.models.jax_import import \
    import_flow_params
from pedestrians_video_2_carla_torch.utils import visualize_heatmaps as TVis

from .test_torch_carla_recorded import CLIP_LEN, COMMON, N_FRAMES, N_VIDEOS
from .test_torch_carla_recorded import carla_csv  # noqa: F401 (fixture)
from .test_torch_pose_estimation import (HEATMAP_ATOL, MODEL_CASES,
                                         SMALL_STAGES, _frames, _port_flow)
from .test_torch_pose_estimation import \
    small_backbone  # noqa: F401 (fixture)


# -- the weight importers -------------------------------------------------------

def _torchvision_sd(stage_sizes, seed=0):
    """A torchvision-layout ResNet state dict of seeded numpy values."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, out_c, in_c, k):
        sd[f"{name}.weight"] = rng.normal(
            scale=0.1, size=(out_c, in_c, k, k)).astype(np.float32)

    def bnorm(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(scale=0.1, size=c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(scale=0.1, size=c).astype(
            np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(3)

    conv("conv1", 64, 3, 7)
    bnorm("bn1", 64)
    in_c = 64
    for stage, blocks in enumerate(stage_sizes):
        feat = 64 * 2 ** stage
        for b in range(blocks):
            t = f"layer{stage + 1}.{b}"
            conv(f"{t}.conv1", feat, in_c if b == 0 else feat * 4, 1)
            bnorm(f"{t}.bn1", feat)
            conv(f"{t}.conv2", feat, feat, 3)
            bnorm(f"{t}.bn2", feat)
            conv(f"{t}.conv3", feat * 4, feat, 1)
            bnorm(f"{t}.bn3", feat * 4)
            if b == 0:
                conv(f"{t}.downsample.0", feat * 4, in_c, 1)
                bnorm(f"{t}.downsample.1", feat * 4)
        in_c = feat * 4
    sd["fc.weight"] = rng.normal(size=(10, in_c)).astype(np.float32)
    sd["fc.bias"] = np.zeros(10, np.float32)
    return sd


def test_import_torchvision_resnet_matches_jax():
    stages = (1, 2, 1, 1)
    sd = _torchvision_sd(stages)
    params, stats = JR.import_torchvision_resnet(sd, stages)
    ref = import_flow_params({"m": params}, device="cpu",
                             mutables={"m": {"batch_stats": stats}})["m"]
    got = TR.import_torchvision_resnet(sd, stages)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    # and it is the port model's own layout
    TR.ResNet(stage_sizes=stages).load_state_dict(got)


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_graft_resnet_backbone_matches_jax(backbone):
    """UniPoseLSTM's 4-channel conv1 keeps its centre-map slice and takes
    torchvision's RGB; the 101 is told by ``layer3.10.``."""
    stages = TR.RESNET101_STAGES if backbone == "resnet101" \
        else TR.RESNET50_STAGES
    sd = _torchvision_sd(stages, seed=1)
    # a UniPoseLSTM parameter dict of that depth (its backbone's layout is
    # the importer's: test_import_torchvision_resnet_matches_jax) with a
    # 4-channel conv1 and a head
    gen = torch.Generator().manual_seed(3)
    params = {f"ResNet_0.{k}": torch.randn(v.shape, generator=gen)
              for k, v in TR.import_torchvision_resnet(sd, stages).items()}
    params["ResNet_0.conv1.weight"] = torch.randn(64, 4, 7, 7, generator=gen)
    params["head.weight"] = torch.randn(27, 64, 1, 1, generator=gen)
    j_params = {"ResNet_0": {"conv1": {"kernel": params[
        "ResNet_0.conv1.weight"].numpy().transpose(2, 3, 1, 0)}},
        "head": {"kernel": np.zeros((1, 1, 64, 27), np.float32)}}
    j_new, j_stats = JT.graft_resnet_backbone(sd, j_params, {})
    ref = import_flow_params({"m": {"ResNet_0": j_new["ResNet_0"]}},
                             device="cpu", mutables={"m": {
                                 "batch_stats": j_stats}})["m"]
    got = TT.graft_resnet_backbone(sd, params)
    assert set(got) == set(params)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    conv1 = got["ResNet_0.conv1.weight"]
    assert torch.equal(conv1[:, 3], params["ResNet_0.conv1.weight"][:, 3])
    assert torch.equal(conv1[:, :3], torch.from_numpy(sd["conv1.weight"]))
    assert torch.equal(got["head.weight"], params["head.weight"])
    with pytest.raises(ValueError, match="does not fit"):
        TT.graft_resnet_backbone(_torchvision_sd(TR.RESNET50_STAGES),
                                 params) if backbone == "resnet101" else \
            TT.graft_resnet_backbone(_torchvision_sd(TR.RESNET101_STAGES),
                                     params)


def test_trainer_grafts_a_backbone_file(tmp_path, small_backbone,
                                        monkeypatch):
    """``Trainer.restore_pretrained_backbone`` on a file: the backbone's
    entries are the file's (a ResNet-50 of one block a stage here, in the
    model and the file alike), conv1's 4th channel and the rest of the
    model stay, in place, still trained leaves."""
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)
    monkeypatch.setattr(TR, "RESNET50_STAGES", (1, 1, 1, 1))

    class _DM:
        device = torch.device("cpu")
        batch_size, train_set_size = 1, 1

        def uses_infinite_train_set(self):
            return False

    sd = _torchvision_sd((1, 1, 1, 1), seed=4)
    path = str(tmp_path / "resnet50.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)
    flow = _port_flow()
    trainer = Trainer(flow, _DM(), TrainerConfig(
        logs_dir=str(tmp_path), run_name="r", device="cpu"))
    trainer._init_state()
    tree = trainer.state.params["movements"]
    before = {k: v.clone() for k, v in tree.items()}
    trainer.restore_pretrained_backbone(path)
    backbone = TR.import_torchvision_resnet(sd, (1, 1, 1, 1))
    for k, v in tree.items():
        name = k[len("ResNet_0."):]
        if name == "conv1.weight":
            assert torch.equal(v[:, :3], backbone[name])
            assert torch.equal(v[:, 3], before[k][:, 3])
        elif k.startswith("ResNet_0."):
            assert torch.equal(v, backbone[name]), k
        else:
            assert torch.equal(v, before[k]), k
    assert tree["ResNet_0.layer1_0.conv1.weight"].requires_grad


# -- the video data modules ------------------------------------------------------

def _write_mp4s(vdir, size=(800, 600)):
    """Videos on the 800 x 600 canvas of the CSV's keypoints, every frame a
    gradient that differs by frame and video (so that crops differ)."""
    import cv2
    w, h = size
    ys, xs = np.mgrid[0:h, 0:w]
    for vid in range(N_VIDEOS):
        path = os.path.join(vdir, f"video_{vid:02d}.mp4")
        if os.path.exists(path):
            continue
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                                 (w, h))
        for f in range(N_FRAMES):
            frame = np.stack([(xs // 4 + 5 * f) % 256, (ys // 3 + 40 * vid)
                              % 256, np.full_like(xs, 9 * f % 256)], -1)
            writer.write(frame.astype(np.uint8))
        writer.release()


def _video_dm(side, carla_csv, out, **kw):
    module = TC if side == "port" else JC
    if side == "port":
        kw["device"] = "cpu"
    dm = module.CarlaRecordedVideoDataModule(
        datasets_dir=carla_csv, outputs_dir=str(out), **{**COMMON, **kw})
    dm.prepare_data()
    dm.setup("fit")
    return dm


@pytest.mark.parametrize("crop", [True, False], ids=["crop", "full"])
def test_video_batches_match_jax(carla_csv, tmp_path, crop):  # noqa: F811
    _write_mp4s(os.path.join(carla_csv, "default"))
    kw = dict(video_size=(64, 48), crop_to_bbox=crop, needs_heatmaps=True,
              heatmaps_stride=4, heatmaps_sigma=2.0)
    port = list(_video_dm("port", carla_csv, tmp_path / "p", **kw)
                .val_batches())
    ref = list(_video_dm("jax", carla_csv, tmp_path / "j", **kw)
               .val_batches())
    assert len(port) == len(ref) > 0
    for (inputs, targets, meta), (j_in, j_tg, j_meta) in zip(port, ref):
        assert inputs.shape == (COMMON["batch_size"], CLIP_LEN, 3, 64, 48)
        np.testing.assert_allclose(inputs.numpy(),
                                   np.moveaxis(np.asarray(j_in), -1, 2),
                                   rtol=0, atol=1e-6)
        assert targets["heatmaps"].shape == (COMMON["batch_size"], CLIP_LEN,
                                             27, 64 // 4, 48 // 4)
        np.testing.assert_allclose(targets["heatmaps"].numpy(),
                                   np.asarray(j_tg["heatmaps"]), rtol=0,
                                   atol=HEATMAP_ATOL)
        for k in ("projection_2d", "bboxes"):
            np.testing.assert_allclose(targets[k].numpy(),
                                       np.asarray(j_tg[k]), rtol=0,
                                       atol=1e-5)
        assert set(meta) == set(j_meta)
        assert all(isinstance(v, torch.Tensor) for v in meta.values())
    # the crops are the JAX mixin's on the same points
    bbox = np.asarray(ref[0][1]["bboxes"])[0]
    assert TV.crop_rect((600, 800), bbox) == JV.crop_rect((600, 800), bbox)
    frames = np.zeros((2, 600, 800, 3), np.uint8)
    assert TV.square_crop(frames, bbox).shape \
        == JV.square_crop(frames, bbox).shape


def test_video_helpers_match_jax(tmp_path):
    import cv2
    path = str(tmp_path / "vid.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (64, 48))
    for i in range(10):
        writer.write(np.full((48, 64, 3), i * 20, np.uint8))
    writer.release()
    frames = TV.read_clip_frames(path, 2, 6)
    np.testing.assert_array_equal(frames, JV.read_clip_frames(path, 2, 6))
    assert TV.read_clip_frames(path, 8, 12) is None
    assert TV.read_clip_frames(str(tmp_path / "none.mp4"), 0, 1) is None
    np.testing.assert_array_equal(TV.to_model_frames(frames, (32, 24)),
                                  JV.to_model_frames(frames, (32, 24)))
    for bbox in (np.asarray([[10, 10], [40, 30]], np.float32),
                 np.asarray([[70, 60], [90, 80]], np.float32)):
        assert TV.crop_rect((48, 64), bbox) == JV.crop_rect((48, 64), bbox)


def test_video_module_drops_batches_it_cannot_decode(carla_csv,  # noqa: F811
                                                     tmp_path):
    """A batch with a clip whose video is missing is dropped whole, with a
    warning; the module streams (never device-resident) and keeps the
    string metas on the host until then."""
    _write_mp4s(os.path.join(carla_csv, "default"))
    dm = _video_dm("port", carla_csv, tmp_path, device_resident=True,
                   video_size=(32, 32))
    assert not dm.device_resident and dm._keep_string_meta
    assert dm.resident_scan_inputs("train", True, True) is None
    inputs, targets, meta = next(iter(super(
        TV.VideoDataModuleMixin, dm).val_batches()))
    assert meta["video_id"].dtype.kind == "U"
    good = (inputs, targets, meta)
    bad = (inputs, targets, {**meta, "video_id": np.asarray(
        ["video_00.mp4", "nowhere.mp4"] + list(meta["video_id"][2:]))})
    with pytest.warns(UserWarning, match="nowhere.mp4"):
        out = list(dm._with_video_inputs(iter([bad, good])))
    assert len(out) == 1 and out[0][0].shape[-2:] == (32, 32)
    assert "video_id" not in out[0][2]


def test_registry_names_the_video_modules():
    modules = discover()
    assert modules["CarlaRecordedVideo"] is TC.CarlaRecordedVideoDataModule
    assert modules["JAADUniPose"] is JAADUniPoseDataModule
    # every name of the JAX registry (the mixed and SMPL modules too)
    from pedestrians_video_2_carla_tpu.data import discover as j_discover
    assert set(modules) == set(j_discover()) and len(modules) == 15


def test_jaad_unipose_extracts_frame_pixel_keypoints(tmp_path,
                                                    small_backbone):
    """JAADUniPose's extraction on a clip of a video the test writes: the
    port's UniPoseLSTM ("resnet50", cut to one block a stage; seeded
    weights) on the bbox crop, the argmax keypoints back in frame pixels,
    inside the crop, confidence 1."""
    import cv2
    import pandas as pd
    vdir = tmp_path / "JAAD" / "videos"
    vdir.mkdir(parents=True)
    writer = cv2.VideoWriter(str(vdir / "video_0001.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (160, 120))
    for i in range(6):
        writer.write(np.full((120, 160, 3), 30 * i, np.uint8))
    writer.release()
    dm = JAADUniPoseDataModule(datasets_dir=str(tmp_path),
                               outputs_dir=str(tmp_path / "out"),
                               video_size=(32, 32), device="cpu")
    clip = pd.DataFrame({"video": ["video_0001"] * 3, "frame": [1, 2, 3],
                         "x1": [40.0] * 3, "y1": [30.0] * 3,
                         "x2": [80.0] * 3, "y2": [90.0] * 3,
                         "keypoints": pd.Series([None] * 3, dtype=object)})
    (info,) = dm._extract_additional_data([clip])
    kp = np.asarray(info["keypoints"].tolist())
    assert kp.shape == (3, 25, 3) and (kp[..., 2] == 1).all()
    x1c, y1c, x2c, y2c = TV.crop_rect((120, 160), np.asarray(
        [40, 30, 80, 90], np.float32))
    assert (kp[..., 0] >= x1c).all() and (kp[..., 0] < x2c).all()
    assert (kp[..., 1] >= y1c).all() and (kp[..., 1] < y2c).all()
    assert dm._extract_additional_data([clip.assign(video="missing")]) == []


# -- the debugging view and the CLI ---------------------------------------------

def test_visualize_heatmaps_matches_jax(tmp_path):
    frames = _frames((1, 2, 3, 16, 12), seed=13)
    maps = np.random.default_rng(14).uniform(0, 1, (1, 2, 4, 8, 6)).astype(
        np.float32)
    got = TVis.visualize_heatmaps(frames, maps, 0, 1,
                                  output_path=str(tmp_path / "a.png"))
    ref = JVis.visualize_heatmaps(frames, maps, 0, 1)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (5 * 16, 12, 3)
    assert os.path.getsize(tmp_path / "a.png") > 0


@pytest.mark.parametrize("model", list(MODEL_CASES))
def test_cli_trains_on_recorded_videos(carla_csv, tmp_path,  # noqa: F811
                                       model, small_backbone):
    """A CLI fit of each model (its "resnet50" cut to one block a stage)
    on the synthesized CarlaRecordedVideo set: UniPoseLSTM on the
    heatmaps loss with the fit-start baseline pass (no predictions on
    frames, so no ``initial_*`` metric), the others on ``loc_2d``."""
    _write_mp4s(os.path.join(carla_csv, "default"))
    flags = ["--backbone", "resnet50", "--loss_modes", "heatmaps"] \
        if model == "UniPoseLSTM" else ["--loss_modes", "loc_2d",
                                        "--skip_initial_metrics=true"]
    results = modeling.main([
        "--flow=pose_estimation", "--data_module_name=CarlaRecordedVideo",
        f"--movements_model_name={model}", *flags,
        f"--datasets_dir={carla_csv}", f"--outputs_dir={tmp_path / 'out'}",
        "--batch_size=2", f"--clip_length={CLIP_LEN}", "--clip_offset=4",
        "--val_set_frac=0.25", "--test_set_frac=0.25", "--video_size", "32",
        "32", "--heatmaps_sigma", "2.0", "--max_epochs=1",
        "--limit_train_batches=2", "--limit_val_batches=1",
        "--log_every_n_steps=1", "--device=cpu", f"--root_dir={tmp_path}",
        "--run_name=r"])
    dm, flow = results["dm"], results["flow"]
    assert dm.video_size == (32, 32) and dm.heatmaps_sigma == 2.0
    assert dm.needs_heatmaps == (model == "UniPoseLSTM")
    with open(tmp_path / "logs" / "pose_estimation" / "r"
              / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records
             if "train_loss/primary" in r and "epoch" not in r]
    assert len(steps) == 2
    assert all(np.isfinite(r["train_loss/primary"]) for r in steps)
    assert np.isfinite(results["val_metrics"]["val_loss/primary"])
    assert type(flow.movements_model).__name__ == model


def test_cli_grafts_a_pretrained_backbone(carla_csv, tmp_path,  # noqa: F811
                                          small_backbone, monkeypatch):
    """``--pretrained_backbone_path`` in test mode: the evaluated model's
    backbone is the file's (conv1's RGB slice, the blocks, their running
    statistics), the rest its seeded init (a ResNet-50 of one block a
    stage in the model and the file alike)."""
    monkeypatch.setattr(TR, "RESNET50_STAGES", SMALL_STAGES)
    _write_mp4s(os.path.join(carla_csv, "default"))
    sd = _torchvision_sd(SMALL_STAGES, seed=6)
    path = str(tmp_path / "resnet50.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)
    results = modeling.main([
        "--flow=pose_estimation", "--data_module_name=CarlaRecordedVideo",
        "--backbone", "resnet50", "--loss_modes", "heatmaps", "--mode=test",
        f"--pretrained_backbone_path={path}", f"--datasets_dir={carla_csv}",
        f"--outputs_dir={tmp_path / 'out'}", "--batch_size=2",
        f"--clip_length={CLIP_LEN}", "--clip_offset=4", "--video_size", "32",
        "32", "--limit_test_batches=1", "--device=cpu",
        f"--root_dir={tmp_path}", "--run_name=t"])
    tree = results["trainer"].state.params["movements"]
    backbone = TR.import_torchvision_resnet(sd, SMALL_STAGES)
    assert torch.equal(tree["ResNet_0.conv1.weight"][:, :3],
                       backbone["conv1.weight"])
    for k in ("layer4_0.conv3.weight", "layer3_0.downsample_bn.running_var"):
        assert torch.equal(tree[f"ResNet_0.{k}"], backbone[k]), k
    own = results["flow"].movements_model.state_dict()
    assert torch.equal(tree["head.weight"], own["head.weight"])
    assert np.isfinite(results["test_metrics"]["test_loss/primary"])
