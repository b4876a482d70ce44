"""The port's CLI against the JAX CLI, on the CPU.

* Flag parity: for every flow the port has (pose estimation among them)
  and every model of its registries, the option strings the JAX CLI
  defines and the port's does not are exactly ``M8_FLAGS``, now none
  (the multi-card flags came with ``parallel/``).
* Value parity: both CLIs on one argument list, stopped where they would
  make the trainer. The flows' optimizer settings (the bare ``--lr``
  among them), the trainer's configuration (its ``mesh`` among them), the
  data module's settings and the models' fields are equal.
* The models that ``--residual``, ``--needs_confidence`` and
  ``--input_features`` change give the JAX models' outputs on the same
  inputs and weights (atol 1e-5, ``tests/ops/test_pallas_graph_gru.py``'s
  forward bar); the flags that are XLA controls (``--unroll``,
  ``--remat``, ``--scan_unroll``) change no output and no gradient.
* F13: a ``fast_dev_run`` data module and a full one of the same settings
  have different digests, and the full digest is the JAX package's.
"""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu import modeling as jmodeling
from pedestrians_video_2_carla_tpu.data.carla import \
    carla_recorded as JRecorded
from pedestrians_video_2_carla_tpu.flows import available_flows

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.data.carla import \
    carla_recorded as TRecorded
from pedestrians_video_2_carla_torch.models.jax_import import \
    import_flow_params
from .torch_threads import limit_torch_threads

limit_torch_threads()

#: the JAX CLI's flags that come with M8's modules not yet ported: none
#: since the multi-card ones came with ``parallel/``
M8_FLAGS = set()
OUT_ATOL = 1e-5


def jax_parser(argv):
    """The parser the JAX CLI's ``setup_flow`` builds for ``argv``."""
    flows, _ = jmodeling.discover_available_classes()
    phase1 = argparse.ArgumentParser(add_help=False)
    jmodeling.add_program_args(phase1)
    known, _ = phase1.parse_known_args(argv)
    flow_cls = flows[known.flow]
    parser = argparse.ArgumentParser(add_help=False)
    for add in (jmodeling.add_program_args, jmodeling.add_trainer_args,
                jmodeling.add_datamodule_args, jmodeling.add_flow_args):
        add(parser)
    seen = set()
    for model_type, models in flow_cls.get_available_models().items():
        default = flow_cls.get_default_models().get(model_type)
        flag = f"--{model_type}_model_name"
        parser.add_argument(flag, default=default.__name__)
        jmodeling.add_optimizer_args(parser, model_type)
        peek = argparse.ArgumentParser(add_help=False)
        peek.add_argument(flag, default=default.__name__)
        chosen = getattr(peek.parse_known_args(argv)[0],
                         f"{model_type}_model_name")
        jmodeling.add_model_args(parser, models[chosen], seen)
    return parser


def options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def _flow_models():
    for flow in modeling.FLOWS:
        for model_type, models in available_flows()[
                flow].get_available_models().items():
            for name in models:
                yield flow, model_type, name


@pytest.mark.parametrize("flow", list(modeling.FLOWS))
def test_flag_gap_is_m8_at_every_flow_and_model(flow):
    jflow = available_flows()[flow]
    cases = [[]] + [[f"--{t}_model_name", name]
                    for t, models in jflow.get_available_models().items()
                    for name in models]
    for extra in cases:
        argv = ["--flow", flow, *extra]
        gap = options(jax_parser(argv)) - options(modeling.make_parser(argv))
        assert gap == M8_FLAGS, (argv, sorted(gap ^ M8_FLAGS))


@pytest.mark.parametrize("flow,model_type,name", list(_flow_models()))
def test_shared_flags_have_the_jax_defaults(flow, model_type, name):
    """Every shared flag's default, in the port's terms: the port names
    the JAX ``xla`` route ``plain``, and 0 is its "no embedding"."""
    argv = ["--flow", flow, f"--{model_type}_model_name", name]
    jdefaults = {a.dest: a.default for a in jax_parser(argv)._actions}
    pdefaults = {a.dest: a.default
                 for a in modeling.make_parser(argv)._actions}
    renamed = {("projection_kernel", "xla"): "plain",
               ("embeddings_size", None): 0}
    for dest, default in jdefaults.items():
        if dest in pdefaults and dest != "help":
            want = renamed.get((dest, default), default) \
                if isinstance(default, (str, type(None))) else default
            assert pdefaults[dest] == want, (dest, default, pdefaults[dest])


def test_verbosity_flags_swallow_nothing():
    parser = modeling.make_parser([])
    args, unknown = parser.parse_known_args(
        ["-vv", "--lr", "0.1", "--train_proportions", "0.5", "0.5",
         "--model_devices", "2", "--max_videos", "2"])
    assert args.very_verbose and not args.verbose
    assert args.lr == 0.1 and args.max_videos == 2
    assert args.train_proportions == [0.5, 0.5]
    assert args.model_devices == 2 and unknown == []
    args, unknown = parser.parse_known_args(["-v", "--num_devices", "1"])
    assert args.verbose and not args.very_verbose
    assert args.num_devices == 1 and unknown == []


class _Stop(Exception):
    pass


def built(main_module, argv, monkeypatch):
    """What ``main`` hands the trainer for ``argv``: (flow, data module,
    config, video logger); the run stops there."""
    got = {}

    def capture(flow, dm, config, video_logger=None):
        got.update(flow=flow, dm=dm, config=config, video=video_logger)
        raise _Stop

    monkeypatch.setattr(main_module, "Trainer", capture)
    with pytest.raises(_Stop):
        main_module.main(argv)
    return got


def _model(flow):
    return getattr(flow, "classification_model", None) \
        or flow.movements_model


def _fields(model, names):
    return {n: getattr(model, n) for n in names}


#: shared argument lists, one per group of flags
ARGVS = {
    "lr_and_trainer": [
        "--flow=pose_lifting", "--movements_model_name=LinearAE",
        "--lr", "0.01", "--check_val_every_n_epoch", "3",
        "--skip_initial_metrics", "true", "--logger", "wandb",
        "--logs_dir", "{tmp}/elsewhere", "--run_name", "r",
        "--num_devices", "1", "--model_devices", "1"],
    "lr_beside_a_typed_lr": [
        "--flow=pose_lifting", "--movements_model_name=LinearAE",
        "--lr", "0.01", "--movements_lr", "0.02",
        "--trajectory_weight_decay", "0.5", "--run_name", "r"],
    "classification_lr": [
        "--flow=classification", "--classification_model_name=GConvGRU",
        "--lr", "0.03", "--scan_unroll", "4", "--input_features", "1",
        "--run_name", "r"],
    "carla2d3d": [
        "--flow=pose_lifting", "--movements_model_name=Linear",
        "--random_changes_each_frame", "5", "--max_change_in_deg", "7.5",
        "--max_world_rot_change_in_deg", "2.0",
        "--max_initial_world_rot_change_in_deg", "30", "--batch_size", "3",
        "--clip_length", "4", "--needs_confidence", "true",
        "--output_nodes", "CARLA_SKELETON", "--run_name", "r"],
    "seq2seq": [
        "--flow=autoencoder", "--movements_model_name=Seq2SeqResidualA",
        "--residual", "pure", "--unroll", "4", "--hidden_size", "8",
        "--movements_output_type", "pose_2d", "--run_name", "r"],
    "poseformer": [
        "--flow=pose_lifting", "--movements_model_name=PoseFormer",
        "--remat", "true", "--depth", "1", "--run_name", "r"],
    "pose_estimation_unipose": [
        "--flow=pose_estimation", "--data_module_name=CarlaRecordedVideo",
        "--movements_model_name=UniPoseLSTM", "--backbone", "resnet50",
        "--stride", "4", "--output_stride", "8", "--sigma", "2.0",
        "--lstm_features", "16", "--video_size", "128", "96",
        "--crop_to_bbox", "false", "--heatmaps_sigma", "2.5",
        "--heatmaps_stride", "4", "--loss_modes", "heatmaps",
        "--run_name", "r"],
    "pose_estimation_p0": [
        "--flow=pose_estimation", "--data_module_name=CarlaRecordedVideo",
        "--movements_model_name=P0", "--loss_modes", "loc_2d",
        "--transform", "none", "--run_name", "r"],
    "pose_estimation_transformer": [
        "--flow=pose_estimation", "--data_module_name=CarlaRecordedVideo",
        "--movements_model_name=AvPedestrianPoseTransformer",
        "--num_layers", "2", "--n_heads", "2", "--needs_confidence", "true",
        "--run_name", "r"],
    "pose_estimation_linear": [
        "--flow=pose_estimation", "--data_module_name=CarlaRecordedVideo",
        "--movements_model_name=Linear", "--video_size", "32", "48",
        "--run_name", "r"],
}
#: the model fields each argument list's models must agree on
FIELDS = {
    "lr_and_trainer": (), "lr_beside_a_typed_lr": (),
    "classification_lr": ("scan_unroll", "input_features",
                          "needs_confidence", "hidden_size", "k"),
    "carla2d3d": ("needs_confidence", "input_features"),
    "seq2seq": ("residual", "unroll", "hidden_size", "teacher_mode"),
    "poseformer": ("remat", "depth"),
    "pose_estimation_unipose": ("backbone", "stride", "output_stride",
                                "sigma", "lstm_features", "needs_confidence",
                                "needs_heatmaps"),
    "pose_estimation_p0": ("dilations", "needs_confidence"),
    "pose_estimation_transformer": ("num_layers", "n_heads",
                                    "needs_confidence"),
    "pose_estimation_linear": ("needs_confidence", "needs_heatmaps"),
}
#: the video data modules' settings that the flags set
VIDEO_SETTINGS = ("video_size", "crop_to_bbox", "needs_heatmaps",
                  "heatmaps_sigma", "heatmaps_stride")


@pytest.mark.parametrize("group", list(ARGVS))
def test_both_clis_build_the_same_run(group, tmp_path, monkeypatch):
    argv = [a.format(tmp=tmp_path) for a in ARGVS[group]] + [
        "--device=cpu", f"--root_dir={tmp_path}"]
    port = built(modeling, argv, monkeypatch)
    ref = built(jmodeling, [a for a in argv if a != "--device=cpu"],
                monkeypatch)
    # the optimizer of each model type, --lr among its settings
    for model_type in ("movements", "trajectory", "classification"):
        name = f"{model_type}_optimizer"
        if hasattr(ref["flow"], name):
            assert dataclasses.asdict(getattr(port["flow"], name)) \
                == dataclasses.asdict(getattr(ref["flow"], name)), name
    # the trainer's configuration
    for key in ("max_epochs", "log_every_n_steps", "check_val_every_n_epoch",
                "skip_initial_metrics", "logger", "logs_dir", "run_name",
                "seed", "detect_anomaly"):
        assert getattr(port["config"], key) == getattr(ref["config"], key), \
            key
    assert dataclasses.asdict(port["config"].mesh) \
        == dataclasses.asdict(ref["config"].mesh)
    # the data module's settings
    assert port["dm"].hparams == ref["dm"].hparams
    if hasattr(ref["dm"], "config"):
        assert dataclasses.asdict(port["dm"].config) \
            == dataclasses.asdict(ref["dm"].config)
    # the model's fields
    pmodel, jmodel = _model(port["flow"]), _model(ref["flow"])
    assert type(pmodel).__name__ == type(jmodel).__name__
    if group == "poseformer":  # the port keeps depth as its block count
        assert len(pmodel.blocks) == jmodel.depth == 1
        assert pmodel.remat == jmodel.remat is True
    else:
        assert _fields(pmodel, FIELDS[group]) \
            == _fields(jmodel, FIELDS[group])
    assert port["flow"].needs_confidence == ref["flow"].needs_confidence
    if group.startswith("pose_estimation"):
        assert type(port["flow"]).__name__ == type(ref["flow"]).__name__ \
            == "PoseEstimationFlow"
        assert port["flow"].needs_heatmaps == ref["flow"].needs_heatmaps
        assert [m.name for m in port["flow"].requested_loss_modes] \
            == [m.name for m in ref["flow"].requested_loss_modes]
        assert port["flow"].transform == ref["flow"].transform
        assert type(port["dm"]).__name__ == type(ref["dm"]).__name__ \
            == "CarlaRecordedVideoDataModule"
        for key in VIDEO_SETTINGS:
            assert getattr(port["dm"], key) == getattr(ref["dm"], key), key
        if group == "pose_estimation_linear":  # the port's frame size
            assert pmodel.Dense_0.in_features == 32 * 48 * 3


def test_bare_lr_trains_every_model_type_at_it(tmp_path, monkeypatch):
    argv = ["--flow=pose_lifting", "--movements_model_name=LinearAE",
            "--lr", "0.01", "--device=cpu", f"--root_dir={tmp_path}",
            "--run_name=r"]
    flow = built(modeling, argv, monkeypatch)["flow"]
    state = flow.init_state()
    lrs = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    assert lrs == {"movements": 0.01, "trajectory": 0.01}
    cls = built(modeling, ["--flow=classification", "--lr", "0.01",
                           "--device=cpu", f"--root_dir={tmp_path}",
                           "--run_name=c"], monkeypatch)["flow"]
    assert [g["lr"] for g in cls.init_state().optimizer.param_groups] \
        == [0.01]


#: (argument list, input channels): models whose inputs, weights or
#: decoder these flags change
OUTPUT_CASES = {
    "residual_keep": (["--flow=autoencoder",
                       "--movements_model_name=Seq2SeqEmbeddings",
                       "--residual", "keep", "--hidden_size", "8",
                       "--single_joint_embeddings_size", "4",
                       "--p_dropout", "0", "--movements_output_type",
                       "pose_2d"], 2),
    "residual_none_on_ResidualB": (["--flow=autoencoder",
                                    "--movements_model_name="
                                    "Seq2SeqResidualB",
                                    "--residual", "none", "--hidden_size",
                                    "8", "--single_joint_embeddings_size",
                                    "4", "--p_dropout", "0",
                                    "--movements_output_type", "pose_2d"],
                                   2),
    "lstm_confidence": (["--movements_model_name=LSTM", "--hidden_size", "8",
                         "--needs_confidence", "true"], 3),
    "linear_confidence": (["--movements_model_name=Linear",
                           "--needs_confidence", "true",
                           "--movements_output_type", "pose_2d"], 3),
    "seq2seq_confidence": (["--flow=autoencoder",
                            "--movements_model_name=Seq2SeqFlatEmbeddings",
                            "--needs_confidence", "true", "--hidden_size",
                            "8", "--p_dropout", "0",
                            "--movements_output_type", "pose_2d"], 3),
    "classifier_lstm_confidence": (["--flow=classification",
                                    "--classification_model_name=LSTM",
                                    "--hidden_size", "8",
                                    "--needs_confidence", "true"], 3),
    "gconvgru_input_features_1": (["--flow=classification",
                                   "--classification_model_name=GConvGRU",
                                   "--hidden_size", "8",
                                   "--input_features", "1"], 2),
    "gconvgru_confidence": (["--flow=classification",
                             "--classification_model_name=GConvGRU",
                             "--hidden_size", "8", "--input_features", "3",
                             "--needs_confidence", "true"], 3),
}


@pytest.mark.parametrize("case", list(OUTPUT_CASES))
def test_flagged_models_give_the_jax_outputs(case, tmp_path, monkeypatch):
    flags, channels = OUTPUT_CASES[case]
    common = [f"--root_dir={tmp_path}", "--run_name=r"]
    port = built(modeling, flags + common + ["--device=cpu"], monkeypatch)
    ref = built(jmodeling, flags + common, monkeypatch)
    assert port["flow"].needs_confidence == ref["flow"].needs_confidence \
        == (channels == 3)
    x = np.random.default_rng(5).normal(
        size=(3, 5, 26, channels)).astype(np.float32)
    jmodel = _model(ref["flow"])
    key = jax.random.PRNGKey(2)
    variables = jmodel.init({"params": key, "dropout": key}, x,
                            training=False)
    want = jax.device_get(jmodel.apply(variables, x, training=False))
    model_type = "classification" \
        if hasattr(port["flow"], "classification_model") else "movements"
    pmodel = _model(port["flow"])
    pmodel.load_state_dict(import_flow_params(
        {model_type: jax.device_get(variables["params"])},
        device="cpu")[model_type])
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), training=False)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_ATOL)


#: (model, the flag, its values): XLA controls in the JAX package
XLA_CONTROLS = {
    "unroll": ("Seq2SeqEmbeddings", {"hidden_size": 8,
                                     "single_joint_embeddings_size": 4,
                                     "p_dropout": 0.0},
               "unroll", (1, 4)),
    "remat": ("PoseFormer", {"depth": 1, "receptive_frames": 3,
                             "single_joint_embeddings_size": 8,
                             "num_heads": 2},
              "remat", (False, True)),
    "scan_unroll": ("GConvGRU", {"hidden_size": 8}, "scan_unroll", (1, 16)),
}


@pytest.mark.parametrize("case", list(XLA_CONTROLS))
def test_xla_controls_change_no_output_or_gradient(case):
    from pedestrians_video_2_carla_torch.models.classification import \
        CLASSIFICATION_MODELS
    from pedestrians_video_2_carla_torch.models.movements import \
        MOVEMENTS_MODELS
    name, kwargs, flag, values = XLA_CONTROLS[case]
    registry = CLASSIFICATION_MODELS if name in CLASSIFICATION_MODELS \
        else MOVEMENTS_MODELS
    assert flag in modeling.model_params(registry[name])
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 5, 26, 2)).astype(np.float32))
    runs = []
    for value in values:
        model = registry[name](generator=torch.Generator().manual_seed(0),
                               **{flag: value}, **kwargs)
        out = model(x, training=False)
        grads = torch.autograd.grad(out.square().sum(),
                                    list(model.parameters()))
        runs.append((out.detach(), grads))
    (out_a, grads_a), (out_b, grads_b) = runs
    assert torch.equal(out_a, out_b)
    assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))


@pytest.mark.parametrize("kwargs", [
    {}, {"data_variant": "other", "clip_length": 8}],
    ids=["default", "variant"])
def test_fast_dev_run_prepares_apart_and_full_digests_are_jax(kwargs,
                                                            tmp_path):
    """F13: ``fast_dev_run`` is in the settings only when true."""
    common = {**kwargs, "outputs_dir": str(tmp_path),
              "datasets_dir": str(tmp_path)}
    full = TRecorded.CarlaRecordedDataModule(device="cpu", **common)
    fast = TRecorded.CarlaRecordedDataModule(device="cpu",
                                             fast_dev_run=True, **common)
    ref = JRecorded.CarlaRecordedDataModule(**common)
    assert full.settings_digest == ref.settings_digest
    assert full.settings == ref.settings
    assert fast.settings == {**full.settings, "fast_dev_run": True}
    assert fast.settings_digest != full.settings_digest
    assert fast.subsets_dir != full.subsets_dir
