"""Port parity for prediction and flow chaining, on the CPU:
``Trainer.predict`` against the JAX package's on a ``SubsetsDataModule``
over HDF5 subsets that the test writes (read by both packages, the same
weights through the bridge); ``save_predictions`` of the same outputs by
both packages (equal datasets and ``dparams.yaml``, read back by the
port); the CLI's ``predict``, ``export`` and ``tune`` modes through
``modeling.main``, ``predict`` and ``export`` against the JAX CLI's on the
same weights and data; the three chaining scripts at tiny sizes, their
result keys against the JAX scripts'. Bars: 1e-3 px on projections, 1e-5
elsewhere."""
import functools
import os

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

from pedestrians_video_2_carla_tpu import modeling as jmodeling
from pedestrians_video_2_carla_tpu import serving as JS
from pedestrians_video_2_carla_tpu.classification_finetuning import \
    main as j_finetuning
from pedestrians_video_2_carla_tpu.data.base.subsets_datamodule import \
    SubsetsDataModule as JSubsetsDataModule
from pedestrians_video_2_carla_tpu.flows.autoencoder import \
    AutoencoderFlow as JAutoencoderFlow
from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.movements import \
    MOVEMENTS_MODELS as J_MOVEMENTS
from pedestrians_video_2_carla_tpu.replacement_metric_flow import \
    main as j_replacement
from pedestrians_video_2_carla_tpu.separated_classification import \
    main as j_separated
from pedestrians_video_2_carla_tpu.training.trainer import (
    Trainer as JTrainer, TrainerConfig as JTrainerConfig)

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch import serving as TS
from pedestrians_video_2_carla_torch.classification_finetuning import \
    main as t_finetuning
from pedestrians_video_2_carla_torch.data.base.hdf5_utils import save_subset
from pedestrians_video_2_carla_torch.data.base.subsets_datamodule import \
    SubsetsDataModule
from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
    Carla2D3DDataModule
from pedestrians_video_2_carla_torch.flows.autoencoder import AutoencoderFlow
from pedestrians_video_2_carla_torch.models.jax_import import \
    import_flow_params
from pedestrians_video_2_carla_torch.models.movements import \
    MOVEMENTS_MODELS
from pedestrians_video_2_carla_torch.replacement_metric_flow import \
    main as t_replacement
from pedestrians_video_2_carla_torch.separated_classification import \
    main as t_separated
from pedestrians_video_2_carla_torch.training.checkpoint import \
    CheckpointManager
from pedestrians_video_2_carla_torch.training.trainer import (Trainer,
                                                              TrainerConfig)
from .torch_threads import limit_torch_threads

limit_torch_threads()

BATCH, L = 4, 6
#: clips a set: not a multiple of the batch, so evaluation wraps around
SET_SIZES = {"train": 8, "val": 6, "test": 10}
#: the flags both CLIs take for the subsets' autoencoder
AE_FLAGS = ["--flow=autoencoder", "--movements_model_name=LinearAE2D",
            "--loss_modes", "loc_2d", f"--batch_size={BATCH}",
            f"--clip_length={L}"]


def _close(port, ref, atol, msg=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=0.0, err_msg=msg)


def _same_tree(port, ref, what):
    """The bars: 1e-3 px on ``projection_2d``'s x and y, 1e-5 elsewhere;
    a value the flow leaves out is ``None`` in both."""
    assert set(port) == set(ref), what
    for k, v in port.items():
        if v is None or ref[k] is None:
            assert v is None and ref[k] is None, (what, k)
            continue
        v, r = np.asarray(v), np.asarray(ref[k])
        assert v.shape == r.shape, (what, k)
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(v, r, err_msg=f"{what} {k}")
        elif k == "projection_2d":
            _close(v[..., :2], r[..., :2], 1e-3, f"{what} {k}")
            _close(v[..., 2:], r[..., 2:], 1e-5, f"{what} {k}")
        else:
            _close(v, r, 1e-5, f"{what} {k}")


@pytest.fixture(scope="module")
def subsets(tmp_path_factory):
    """A subsets tree of CARLA-skeleton clips in pixels (Carla2D3D's
    renders) with crossing labels, as a datamodule of either package
    writes one."""
    root = str(tmp_path_factory.mktemp("subsets"))
    dm = Carla2D3DDataModule(batch_size=sum(SET_SIZES.values()),
                             clip_length=L, test_set_size=24, device="cpu")
    _, targets, _ = next(iter(dm.test_batches()))
    clips = targets["projection_2d"][..., :2].numpy()
    labels = np.arange(len(clips)) % 2
    start = 0
    for name, n in SET_SIZES.items():
        save_subset(os.path.join(root, f"{name}.hdf5"),
                    clips[start:start + n],
                    {"crossing": labels[start:start + n]}, {})
        start += n
    with open(os.path.join(root, "dparams.yaml"), "w") as f:
        yaml.safe_dump({"data_module_name": "Carla2D3DDataModule",
                        "clip_length": L, "clip_offset": L,
                        "data_nodes": "CARLA_SKELETON",
                        **{f"{k}_set_size": v for k, v in SET_SIZES.items()}},
                       f)
    return root


@functools.lru_cache(maxsize=None)
def _jax_predictions(subsets, set_name):
    """The JAX package's ``Trainer.predict`` over the subsets with an
    autoencoder (LinearAE2D, its own seeded init) and its parameters."""
    dm = JSubsetsDataModule(subsets_dir=subsets, batch_size=BATCH,
                            clip_length=L)
    dm.prepare_data()
    dm.setup("predict")
    flow = JAutoencoderFlow(movements_model=J_MOVEMENTS["LinearAE2D"](),
                            loss_modes=[JLossModes.loc_2d],
                            movements_optimizer=JOptimizerSettings(lr=1e-3))
    trainer = JTrainer(flow, dm, JTrainerConfig(
        logs_dir=os.path.join(subsets, "jax_logs"), run_name="predict"))
    outputs = trainer.predict(set_name)
    return jax.device_get(trainer.state.params), outputs


def _port_trainer(subsets, params):
    dm = SubsetsDataModule(subsets_dir=subsets, batch_size=BATCH,
                           clip_length=L, device="cpu")
    dm.prepare_data()
    dm.setup("predict")
    flow = AutoencoderFlow(MOVEMENTS_MODELS["LinearAE2D"](),
                           loss_modes=["loc_2d"], device="cpu")
    trainer = Trainer(flow, dm, TrainerConfig(
        logs_dir=os.path.join(subsets, "port_logs"), run_name="predict",
        device="cpu"))
    trainer.state = flow.init_state(import_flow_params(params,
                                                       device="cpu"))
    return trainer


@pytest.mark.parametrize("set_name", ["val", "test"])
def test_trainer_predict_matches_jax(subsets, set_name):
    j_params, j_outputs = _jax_predictions(subsets, set_name)
    outputs = _port_trainer(subsets, j_params).predict(set_name)
    # the last partial batch wraps around, as evaluation's does
    assert len(outputs) == len(j_outputs) == -(-SET_SIZES[set_name]
                                               // BATCH)
    for i, (port, ref) in enumerate(zip(outputs, j_outputs)):
        for what, p, r in zip(("preds", "targets", "meta"), port, ref):
            _same_tree(p, r, f"batch {i} {what}")
        assert isinstance(port[0]["projection_2d_transformed"], np.ndarray)


def test_save_predictions_matches_jax_and_reads_back(subsets, tmp_path):
    """The same outputs (the JAX package's) saved by both packages: every
    dataset and the ``dparams.yaml`` equal; the port's tree trains as a
    ``--subsets_dir`` (its batches are the predictions, normalised)."""
    dirs = {}
    for package, cls in (("jax", JSubsetsDataModule),
                         ("port", SubsetsDataModule)):
        extra = {"device": "cpu"} if package == "port" else {}
        dm = cls(subsets_dir=subsets, batch_size=BATCH, clip_length=L,
                 outputs_dir=str(tmp_path / package), **extra)
        dm.prepare_data()
        for set_name in ("val", "test"):
            dirs[package] = dm.save_predictions(
                set_name, _jax_predictions(subsets, set_name)[1],
                run_id="chain")
    assert dirs["port"].endswith(os.path.join(
        "SubsetsDataModulePredictions", "subsets",
        os.path.basename(os.path.dirname(dirs["port"])), "chain"))
    for name in ("val.hdf5", "test.hdf5"):
        with h5py.File(os.path.join(dirs["jax"], name)) as j, \
                h5py.File(os.path.join(dirs["port"], name)) as t:
            keys = []
            j.visit(keys.append)
            t_keys = []
            t.visit(t_keys.append)
            assert keys == t_keys
            for k in keys:
                if isinstance(j[k], h5py.Dataset):
                    np.testing.assert_array_equal(t[k][()], j[k][()],
                                                  err_msg=f"{name} {k}")
    with open(os.path.join(dirs["jax"], "dparams.yaml")) as f:
        j_params = f.read()
    with open(os.path.join(dirs["port"], "dparams.yaml")) as f:
        assert f.read() == j_params
    back = SubsetsDataModule(subsets_dir=dirs["port"], batch_size=BATCH,
                             clip_length=L, device="cpu")
    back.prepare_data()
    back.setup("fit")
    assert back.val_set_size == 2 * BATCH and back.test_set_size == 3 * BATCH
    inputs, targets, _ = next(iter(back.val_batches()))
    assert inputs.shape == (BATCH, L, 26, 2)
    assert torch.isfinite(inputs).all()
    assert "crossing" in targets


def test_carla_predicts_a_finite_slice_of_the_train_stream():
    dm = Carla2D3DDataModule(batch_size=2, clip_length=3, val_set_size=3,
                             device="cpu")
    batches = list(dm.predict_batches("train"))
    assert len(batches) == max(1, 4 * dm.val_set_size // dm.batch_size) == 4
    for got, want in zip(batches, dm.train_batches()):
        assert torch.equal(got[0], want[0])
    assert len(list(dm.predict_batches("val"))) == 1


# -- the CLI -----------------------------------------------------------------

def test_cli_test_and_predict_modes(tmp_path):
    """The JAX CLI's test: ``test`` evaluates, ``predict`` fills
    ``results["predictions"]`` for each of ``--predict_sets``."""
    base = ["--flow=pose_lifting", "--movements_model_name=Linear",
            "--loss_modes", "loc_2d", "--data_module_name=Carla2D3D",
            "--batch_size=2", "--clip_length=3", "--val_set_size=2",
            "--test_set_size=2", "--device=cpu", f"--root_dir={tmp_path}"]
    results = modeling.main(base + ["--mode=test"])
    assert np.isfinite(results["test_metrics"]["test_loss/primary"])
    results = modeling.main(base + ["--mode=predict", "--predict_sets",
                                    "val", "train"])
    assert set(results["predictions"]) == {"val", "train"}
    assert len(results["predictions"]["val"]) == 1
    assert len(results["predictions"]["train"]) == 4
    preds, targets, meta = results["predictions"]["val"][0]
    assert preds["projection_2d"].shape == (2, 3, 26, 3)
    assert "age_gender_idx" in meta


def test_cli_tune_and_export_modes(tmp_path):
    """``tune`` fits from a checkpoint's weights alone; ``export`` writes
    ``exported/model.pt2`` from them, which serves what the closure gives
    on the restored weights."""
    base = ["--flow=pose_lifting", "--movements_model_name=LinearAE",
            "--loss_modes", "loc_2d_3d", "--batch_size=2", "--clip_length=3",
            "--val_set_size=2", "--max_epochs=1", "--limit_train_batches=2",
            "--device=cpu", f"--root_dir={tmp_path}"]
    trained = modeling.main(base + ["--mode=train", "--run_name=a"])
    last = tmp_path / "logs" / "pose_lifting" / "a" / "checkpoints" / "last"
    tuned = modeling.main(base + ["--mode=tune", f"--ckpt_path={last}",
                                  "--run_name=b"])
    assert np.isfinite(tuned["val_metrics"]["val_loss/primary"])
    assert tuned["trainer"].state.step == 2     # a fresh optimizer: 0 + 2
    exported = modeling.main(base + [
        "--mode=export", f"--ckpt_path={last}", "--run_name=c",
        "--projection_kernel=fused", "--export_keys", "projection_2d"])
    path = exported["export_path"]
    assert path == str(tmp_path / "logs" / "pose_lifting" / "c"
                       / "exported" / "model.pt2")
    call, meta = TS.load_inference(path, device="cpu")
    assert meta["output_keys"] == ["projection_2d"]
    assert meta["input_shapes"] == [[2, 3, 26, 2], [2]]
    inputs, _, batch_meta = next(iter(trained["dm"].val_batches()))
    served = call(inputs, batch_meta["age_gender_idx"])
    direct = TS.make_inference_fn(
        trained["flow"], trained["trainer"].state.params)(
        inputs, batch_meta["age_gender_idx"])
    _close(served["projection_2d"], direct["projection_2d"], 1e-4)
    poly = modeling.main(base + ["--mode=export", "--run_name=d",
                                 "--export_polymorphic_batch"])
    assert TS.load_inference(poly["export_path"], device="cpu")[1][
        "input_shapes"][0][0] == "b"


def test_cli_refuses_renderers(tmp_path):
    """A name that no package renders is refused at argument time; the
    renderers that need CARLA or SMPL are ported (M8), and the CLI's check
    passes them (tests/test_torch_loggers.py runs them through the CLI)."""
    assert modeling.check_renderers(
        ["carla", "none", "source_carla", "smpl"]) \
        == ["carla", "source_carla", "smpl"]
    with pytest.raises(ValueError, match="unknown renderer"):
        modeling.main(["--renderers", "points", "--device=cpu",
                       f"--root_dir={tmp_path}"])


def test_cli_predict_and_export_match_jax(subsets, tmp_path):
    """Both CLIs on the same subsets and the same weights (the JAX CLI's
    init, handed to the port as a checkpoint): ``predict``'s outputs and
    ``export``'s artifacts agree."""
    common = AE_FLAGS + [f"--subsets_dir={subsets}", "--predict_sets",
                         "val", "test", f"--root_dir={tmp_path}"]
    j_pred = jmodeling.main(common + ["--mode=predict", "--run_name=jp"])
    ckpt = tmp_path / "from_jax"
    port_flow = AutoencoderFlow(MOVEMENTS_MODELS["LinearAE2D"](),
                                loss_modes=["loc_2d"], device="cpu")
    CheckpointManager(str(ckpt)).save(
        port_flow.init_state(import_flow_params(
            jax.device_get(j_pred["trainer"].state.params), device="cpu")),
        {"val_loss/primary": 0.0}, step=0)
    t_pred = modeling.main(common + ["--mode=predict", "--run_name=tp",
                                     "--device=cpu",
                                     f"--ckpt_path={ckpt / 'last'}"])
    for set_name in ("val", "test"):
        port, ref = t_pred["predictions"][set_name], \
            j_pred["predictions"][set_name]
        assert len(port) == len(ref)
        for i, (p, r) in enumerate(zip(port, ref)):
            for what, pp, rr in zip(("preds", "targets", "meta"), p, r):
                _same_tree(pp, rr, f"{set_name} {i} {what}")

    j_exp = jmodeling.main(common + ["--mode=export", "--run_name=je"])
    t_exp = modeling.main(common + ["--mode=export", "--run_name=te",
                                    "--device=cpu",
                                    f"--ckpt_path={ckpt / 'last'}"])
    j_call, j_meta = JS.load_inference(j_exp["export_path"])
    t_call, t_meta = TS.load_inference(t_exp["export_path"], device="cpu")
    assert set(t_meta) == set(j_meta)
    assert t_meta["output_keys"] == j_meta["output_keys"]
    assert t_meta["input_shapes"] == j_meta["input_shapes"]
    x = np.asarray(next(iter(j_pred["dm"].val_batches()))[0])
    agi = np.zeros((BATCH,), np.int32)
    _same_tree({k: v.numpy() for k, v in t_call(x, agi).items()},
               jax.device_get(j_call(x, agi)), "artifacts")


# -- the chaining scripts --------------------------------------------------

CHAIN_FLAGS = ["--data_module_name=Carla2D3D", "--batch_size=4",
               "--clip_length=4", "--val_set_size=4", "--test_set_size=4",
               "--max_epochs=1", "--limit_train_batches=2",
               "--movements_model_name=LinearAE2D",
               "--classification_model_name=LSTM"]


@pytest.mark.parametrize("script", ["classification_finetuning",
                                    "separated_classification",
                                    "replacement_metric_flow"])
def test_chaining_script_matches_the_jax_script(script, tmp_path):
    """Each script at tiny sizes, in both packages: the same result keys;
    in each metric dict a finite primary loss and the JAX script's metric
    names (its ``val/Accuracy`` is the port's ``val_Accuracy``). The values
    differ by the packages' random draws (F3), and so may the metrics that
    some batch fed: a PCK with no countable joint in the data is absent,
    in both packages."""
    mains = {"classification_finetuning": (j_finetuning, t_finetuning),
             "separated_classification": (j_separated, t_separated),
             "replacement_metric_flow": (j_replacement, t_replacement)}
    j_main, t_main = mains[script]

    def flags(package):
        return CHAIN_FLAGS + [f"--root_dir={tmp_path / package}",
                              f"--outputs_dir={tmp_path / package / 'out'}"]
    ref = j_main(flags("jax"))
    got = t_main(flags("port") + ["--device=cpu"])
    if script == "classification_finetuning":
        assert {"trainer", "flow", "dm", "val_metrics"} <= set(got)
        assert set(ref) == set(got)
        ref, got = {"tuned": ref["val_metrics"]}, \
            {"tuned": got["val_metrics"]}
        assert isinstance(got["tuned"], dict)
    assert set(got) == set(ref)
    for key, metrics in got.items():
        assert metrics, key
        assert np.isfinite(metrics[next(k for k in metrics
                                         if k.endswith("loss/primary"))])
        names = {k.replace("/", "_", 1) if not k.startswith(
            ("val_loss", "test_loss")) else k for k in ref[key]}
        assert set(metrics) <= names, key
