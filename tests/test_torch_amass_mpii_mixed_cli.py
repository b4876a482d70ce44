"""The port's CLI against the JAX CLI on AMASS, MPII and a mixed module,
on the CPU, on synthetic files (the writers of
``test_torch_amass_mpii_mixed.py``, and the CarlaRecorded CSV of
``test_torch_carla_recorded.py``).

* BASELINE config 2's flow (``Seq2SeqEmbeddings`` autoencoder,
  ``pose_2d``) fits on AMASS, and the autoencoder with ``LinearAE2D`` on
  ``CarlaRecAMASS`` with ``--train_proportions 0.5 0.5`` and on MPII
  (one-frame clips) in both variants, through both CLIs: the same data
  module settings
  and set sizes, finite losses, the same validation baseline (the inputs
  as predictions, rtol 1e-5), and the proportions in the hparams.
* F14, a fault of both packages: pose lifting on AMASS fails in both, in
  the same place. Without ``--input_nodes`` the projection refuses the 22
  SMPL joints; with ``--input_nodes=CARLA_SKELETON`` the steps run and the
  first validation's pose metrics compare 26 joints with 22.
"""
import json
import os
import traceback

import numpy as np
import pytest

from pedestrians_video_2_carla_tpu import modeling as jmodeling

from pedestrians_video_2_carla_torch import modeling

from pedestrians_video_2_carla_tpu.data.smpl import body_model as JB

from pedestrians_video_2_carla_torch.data.smpl import body_model as TB

from tests.test_torch_amass_mpii_mixed import (write_body_models,
                                               write_mocaps, write_mpii)
from tests.test_torch_carla_recorded import carla_csv  # noqa: F401
from .torch_threads import limit_torch_threads

limit_torch_threads()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory, carla_csv):  # noqa: F811
    """Mocaps, an MPII ``.mat`` and the CarlaRecorded CSV in one
    datasets directory."""
    root = tmp_path_factory.mktemp("datasets")
    write_mocaps(root, frames=40)
    write_mpii(root)
    os.symlink(os.path.join(carla_csv, "default"), root / "default")
    return str(root)


def _run(side, argv, tmp_path):
    """One CLI's ``main`` on ``argv`` under ``tmp_path / side``."""
    out = tmp_path / side
    argv = argv + [f"--outputs_dir={out / 'outputs'}", f"--root_dir={out}",
                   "--run_name=r", "--renderers", "none"]
    if side == "port":
        return modeling.main(argv + ["--device=cpu"])
    return jmodeling.main(argv)


AUTOENCODER = ["--flow=autoencoder", "--movements_output_type=pose_2d",
               "--loss_modes", "loc_2d", "--batch_size=2",
               "--log_every_n_steps=1",
               "--max_epochs=1", "--limit_train_batches=2",
               "--limit_val_batches=2"]
CASES = {
    "AMASS": ["--data_module_name=AMASS", "--clip_length=6",
              "--movements_model_name=Seq2SeqEmbeddings",
              "--hidden_size=8", "--single_joint_embeddings_size=4"],
    "CarlaRecAMASS": ["--data_module_name=CarlaRecAMASS", "--clip_length=6",
                      "--movements_model_name=LinearAE2D",
                      "--train_proportions", "0.5", "0.5"],
    "MPII-single": ["--data_module_name=MPII", "--clip_length=1",
                    "--movements_model_name=LinearAE2D",
                    "--test_set_frac=0"],
    "MPII-multiple": ["--data_module_name=MPII", "--clip_length=1",
                      "--data_variant=multiple",
                      "--movements_model_name=LinearAE2D",
                      "--test_set_frac=0"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_autoencoder_runs_as_the_jax_cli(case, data_root, tmp_path,
                                        monkeypatch):
    argv = AUTOENCODER + CASES[case] + [f"--datasets_dir={data_root}"]
    if case == "AMASS":
        # the synthetic body models at their default place; the mixed case
        # runs without them (zero-length bones)
        write_body_models(tmp_path / "cwd")
        monkeypatch.chdir(tmp_path / "cwd")
    for m in (TB, JB):
        m.get_body_model.cache_clear()
    try:
        port, ref = [_run(side, argv, tmp_path) for side in ("port", "jax")]
    finally:
        for m in (TB, JB):
            m.get_body_model.cache_clear()
    p_dm, r_dm = port["dm"], ref["dm"]
    assert type(p_dm).__name__ == type(r_dm).__name__
    members = getattr(p_dm, "members", [p_dm])
    r_members = getattr(r_dm, "_members", [r_dm])
    for p, r in zip(members, r_members):
        assert p.settings_digest == r.settings_digest
        assert (p.train_set_size, p.val_set_size) \
            == (r.train_set_size, r.val_set_size)
    assert p_dm.hparams.get("train_proportions") \
        == r_dm.hparams.get("train_proportions")
    if case == "CarlaRecAMASS":
        assert p_dm.hparams["train_proportions"] == [0.5, 0.5]
    for key in ("val_loss/loc_2d", "val_loss/primary"):
        assert np.isfinite(port["val_metrics"][key])
        assert np.isfinite(ref["val_metrics"][key])
    with open(os.path.join(port["trainer"].log_dir, "metrics.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if "train_loss/loc_2d" in r]
    assert steps and all(np.isfinite(r["train_loss/loc_2d"]) for r in steps)
    # the validation baseline reads the data alone
    p_init = port["trainer"].initial_metrics()
    r_init = {k.replace("/", "_"): v
              for k, v in ref["trainer"]._initial_metrics().items()}
    assert set(p_init) == set(r_init) and p_init
    for k, v in r_init.items():
        np.testing.assert_allclose(np.asarray(p_init[k], np.float64),
                                   np.asarray(v, np.float64), rtol=1e-5,
                                   err_msg=k)


def _failure(side, argv, tmp_path):
    with pytest.raises(Exception) as info:
        _run(side, argv, tmp_path)
    frames = [f"{os.path.basename(os.path.dirname(f.filename))}/"
              f"{os.path.basename(f.filename)}"
              for f in traceback.extract_tb(info.value.__traceback__)]
    return info.value, frames


@pytest.mark.parametrize("input_nodes", [None, "CARLA_SKELETON"])
def test_f14_pose_lifting_on_amass_fails_in_both(input_nodes, data_root,
                                                 tmp_path):
    argv = ["--flow=pose_lifting", "--data_module_name=AMASS",
            "--movements_model_name=LinearAE", "--batch_size=2",
            "--clip_length=3", "--max_epochs=1", "--limit_train_batches=2",
            "--log_every_n_steps=1", f"--datasets_dir={data_root}"]
    if input_nodes:
        argv.append(f"--input_nodes={input_nodes}")
    (p_err, p_frames), (r_err, r_frames) = (
        _failure(side, argv, tmp_path) for side in ("port", "jax"))
    if input_nodes is None:
        # the projection refuses the SMPL joints at the first step
        assert type(p_err) is type(r_err)
        assert str(p_err) == str(r_err) \
            == "pose_changes input has 22 joints, skeleton has 26"
        assert "ops/projection.py" in p_frames[-1]
        assert "ops/projection.py" in r_frames[-1]
    else:
        # the steps run; the first validation's pose metrics compare the
        # 26 CARLA joints with the 22 SMPL targets (each library words its
        # broadcasting error its own way)
        assert "metrics/pose.py" in p_frames and "metrics/pose.py" in r_frames
        for err in (p_err, r_err):
            assert "26" in str(err) and "22" in str(err)
        with open(tmp_path / "port" / "logs" / "pose_lifting" / "r"
                  / "metrics.jsonl") as f:
            steps = [r for r in map(json.loads, f)
                     if "train_loss/primary" in r]
        assert len(steps) == 2
