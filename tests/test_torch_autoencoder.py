"""Port parity for BASELINE config 2's slice, on the CPU: the six Seq2Seq
variants, ``LSTM``, ``Linear`` and ``ZeroMovements`` against their flax
counterparts through ``models/jax_import.py`` (the bidirectional,
``invert_sequence`` and teacher-forcing cases included), on both of the
port's encoder routes (``rnn_kernel`` plain, and fused: the dense LSTM
kernels' plain version on CPU tensors); one ``AutoencoderFlow``
``training_step`` against the JAX flow's (losses and gradients); the
metrics of an eval pass and the fit-start baseline; the teacher-forcing
decay; and a CPU fit through the CLI.

Bars (``tests/ops/test_pallas_graph_gru.py``): outputs atol 1e-5, each
parameter gradient within 1e-4 of its largest magnitude (atol 1e-5),
losses rtol 1e-4, metrics rtol 1e-5.

Dropout and teacher-forcing masks come from the flow's ``torch.Generator``,
not from the JAX PRNG stream (an accepted difference, ROADMAP.md F3): the
parity cases run with ``p_dropout = 0`` and a teacher-forcing ratio of 0 or
1, whose masks are all-false or all-true in both packages (``uniform <
1.0`` always holds).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.data.carla import carla_2d3d as JD
from pedestrians_video_2_carla_tpu.flows.autoencoder import \
    AutoencoderFlow as JAutoencoderFlow
from pedestrians_video_2_carla_tpu.flows.output_types import \
    MovementsModelOutputType as JMOT
from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
from pedestrians_video_2_carla_tpu.losses import primary_loss as j_primary
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.movements import \
    MOVEMENTS_MODELS as J_MODELS

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.flows.autoencoder import AutoencoderFlow
from pedestrians_video_2_carla_torch.flows.output_types import \
    MovementsModelOutputType as MOT
from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
from pedestrians_video_2_carla_torch.models.jax_import import (
    flax_to_state_dict, import_flow_params, import_seq2seq)
from pedestrians_video_2_carla_torch.models import rnn as R
from pedestrians_video_2_carla_torch.models.movements import MOVEMENTS_MODELS
from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG
from .torch_threads import limit_torch_threads

limit_torch_threads()

B, L, H = 3, 5, 8
LR = 1e-3
OUT_ATOL, GRAD_ATOL = 1e-5, 1e-5

#: (case id, model, output type, constructor options, teacher-forcing run)
CASES = {
    "Seq2Seq": ("Seq2Seq", "pose_2d", {}, False),
    "Seq2SeqEmbeddings": ("Seq2SeqEmbeddings", "pose_2d", {}, False),
    "Seq2SeqFlatEmbeddings": ("Seq2SeqFlatEmbeddings", "pose_2d",
                              {"embeddings_size": (12, 6)}, False),
    "Seq2SeqResidualA": ("Seq2SeqResidualA", "pose_2d", {}, False),
    "Seq2SeqResidualB": ("Seq2SeqResidualB", "pose_2d", {}, False),
    "Seq2SeqResidualC": ("Seq2SeqResidualC", "pose_changes", {}, False),
    "bidirectional": ("Seq2SeqEmbeddings", "pose_2d",
                      {"bidirectional": True}, False),
    "invert_sequence": ("Seq2Seq", "pose_2d", {"invert_sequence": True},
                        False),
    "clip_force_1": ("Seq2SeqEmbeddings", "pose_2d",
                     {"teacher_mode": "clip_force",
                      "teacher_force_ratio": 1.0}, True),
    "frames_force_1": ("Seq2SeqResidualA", "pose_2d",
                       {"teacher_mode": "frames_force",
                        "teacher_force_ratio": 1.0}, True),
    "frames_force_0": ("Seq2SeqEmbeddings", "pose_2d",
                       {"teacher_mode": "frames_force",
                        "teacher_force_ratio": 0.0}, True),
    "rot_mul_force_1": ("Seq2SeqResidualC", "pose_changes",
                        {"teacher_mode": "clip_force",
                         "teacher_force_ratio": 1.0}, True),
    "LSTM": ("LSTM", "pose_changes", {}, False),
    "LSTM_embeddings": ("LSTM", "pose_2d", {"embeddings_size": 12}, False),
    "Linear": ("Linear", "pose_2d", {}, False),
    "ZeroMovements": ("ZeroMovements", "pose_changes", {}, False),
    "ZeroMovements_2d": ("ZeroMovements", "pose_2d", {}, False),
}
#: the cases whose encoder also runs on the fused route
FUSED_CASES = ["Seq2SeqEmbeddings", "Seq2SeqResidualC", "bidirectional",
               "clip_force_1", "LSTM"]


def _sizes(model_name, options):
    sizes = dict(options)
    if model_name.startswith("Seq2Seq"):
        sizes.update(hidden_size=H, p_dropout=0.0)
    if model_name.startswith("Seq2SeqEmbeddings") \
            or model_name.startswith("Seq2SeqResidual"):
        sizes.update(single_joint_embeddings_size=4)
    if model_name == "LSTM":
        sizes.update(hidden_size=H)
    return sizes


@functools.lru_cache(maxsize=None)
def _batch():
    """A seeded Carla2D3D batch (some joints missing) of the JAX package."""
    cfg = JD.Carla2D3DConfig(batch_size=B, clip_length=L,
                             missing_joint_probabilities=(0.1,) * 26)
    return jax.device_get(JD.generate_batch(jax.random.PRNGKey(3), cfg))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """The flax model's params and output on the batch (training with
    teacher forcing where the case forces)."""
    model_name, output_type, options, training = CASES[case]
    model = J_MODELS[model_name](
        movements_output_type=JMOT[output_type],
        **_sizes(model_name, options))
    inputs, targets, _ = _batch()
    key = jax.random.PRNGKey(7)
    variables = model.init({"params": key, "dropout": key}, inputs,
                           training=False)
    out = jax.jit(lambda v: model.apply(
        v, inputs, targets if training else None, training=training,
        rngs={"dropout": jax.random.PRNGKey(9)}))(variables)
    return jax.device_get((variables["params"], out))


def _port_model(case, kernel="plain"):
    model_name, output_type, options, _ = CASES[case]
    kwargs = _sizes(model_name, options)
    if model_name.startswith(("Seq2Seq", "LSTM")):
        kwargs["rnn_kernel"] = kernel
    return MOVEMENTS_MODELS[model_name](
        movements_output_type=MOT[output_type], **kwargs)


def _run_port(case, kernel):
    _, _, _, training = CASES[case]
    params, ref = _jax_case(case)
    model = _port_model(case, kernel)
    model.load_state_dict(import_flow_params(
        {"movements": params}, device="cpu")["movements"])
    inputs, targets, _ = _to_torch(_batch())
    kwargs = {"generator": torch.Generator().manual_seed(0)} \
        if model_name_of(case).startswith("Seq2Seq") else {}
    with torch.no_grad():
        out = model(inputs, targets if training else None,
                    training=training, **kwargs)
    return out, ref


def model_name_of(case):
    return CASES[case][0]


@pytest.mark.parametrize("case", list(CASES))
def test_movements_model_matches_flax(case):
    out, ref = _run_port(case, "plain")
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=OUT_ATOL)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_encoder_matches_flax(case, monkeypatch):
    """``rnn_kernel="fused"``: the encoder's layers run through
    ``graph_lstm_scan`` (its plain version here, on CPU tensors), whose
    route on the card is the dense kernels."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return FG.graph_lstm_scan(*args, **kwargs)
    monkeypatch.setattr(R, "graph_lstm_scan", counted)
    out, ref = _run_port(case, "fused")
    np.testing.assert_allclose(out.numpy(), ref, atol=OUT_ATOL)
    model = _port_model(case)
    layers = model.num_layers * (2 if getattr(model, "bidirectional", False)
                                 else 1)
    # one scan a layer, each a dense LSTM over the batch rows (J = 1) at
    # H <= 64: the shapes the dense kernels take on the card
    assert calls == [(L, B, 1, 4 * H)] * layers


def test_seq2seq_tree_names():
    """The port's Seq2Seq state_dict is the flax tree's, leaf for leaf (the
    scanned decoder's one set of params included); a tree without a
    decoder's ``fc_out`` is refused."""
    params, _ = _jax_case("bidirectional")
    sd = import_seq2seq(params)
    assert set(sd) == set(_port_model("bidirectional").state_dict())
    assert "decoder.lstm_1.hi.bias" in sd and "OptimizedLSTMCell_3.ii.weight" \
        in sd and tuple(sd["joint_embeddings"].shape) == (26, 2, 4)
    with pytest.raises(ValueError, match="Seq2Seq"):
        import_seq2seq({**params, "decoder": {"lstm_0": {}}})
    with pytest.raises(ValueError, match="Seq2Seq"):
        import_seq2seq({**params, "head": {}})
    assert set(flax_to_state_dict(params)) == set(sd)


def test_zero_movements_refuses_other_outputs():
    with pytest.raises(ValueError, match="Unsupported"):
        MOVEMENTS_MODELS["ZeroMovements"](
            movements_output_type=MOT.absolute_loc)
    assert MOVEMENTS_MODELS["ZeroMovements"].supported_output_types() == [
        MOT.pose_changes, MOT.pose_2d]


# -- the autoencoder flow ------------------------------------------------------

def _j_flow():
    model = J_MODELS["Seq2SeqEmbeddings"](
        movements_output_type=JMOT.pose_2d,
        **_sizes("Seq2SeqEmbeddings", {}))
    return JAutoencoderFlow(movements_model=model,
                            loss_modes=[JLossModes.loc_2d],
                            movements_optimizer=JOptimizerSettings(lr=LR))


@functools.lru_cache(maxsize=None)
def _jax_flow_case():
    """The JAX flow's initial params, one training step's losses and
    gradients, and an eval step's metrics and the baseline's."""
    flow = _j_flow()
    batch = _batch()
    state = flow.init_state(jax.random.PRNGKey(1), batch)

    def loss_fn(params):
        sliced, _ = flow._inner_step(params, state.mutables, batch,
                                     training=True,
                                     rngs={"dropout": jax.random.PRNGKey(2)})
        losses = flow._compute_losses(sliced, sliced["targets"])
        return j_primary(losses, flow.requested_loss_modes)[1], losses
    (_, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params)
    eval_losses, preds, targets = flow.eval_step(state, batch)
    mstate = flow.metrics.update(flow.metrics.init_state(), preds, targets)
    inputs, targets, _ = batch
    initial = flow.initial_metrics.update(
        flow.initial_metrics.init_state(),
        flow.initial_preds(inputs, targets), targets)
    return jax.device_get((state.params, losses, grads, eval_losses,
                           flow.metrics.compute(mstate),
                           flow.initial_metrics.compute(initial)))


def _port_flow(kernel):
    model = _port_model("Seq2SeqEmbeddings", kernel)
    return AutoencoderFlow(model, loss_modes=["loc_2d"],
                           movements_optimizer=OptimizerSettings(lr=LR),
                           device="cpu")


def _scaled_close(port, ref, msg=""):
    port, ref = np.asarray(port), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-8)
    np.testing.assert_allclose(port / scale, ref / scale, rtol=1e-4,
                               atol=GRAD_ATOL, err_msg=msg)


@pytest.mark.parametrize("kernel", ["plain", "fused"])
def test_autoencoder_training_step_matches_jax(kernel):
    j_params, j_losses, j_grads, _, _, _ = _jax_flow_case()
    flow = _port_flow(kernel)
    state = flow.init_state(import_flow_params(j_params, device="cpu"))
    _, logs = flow.training_step(state, _to_torch(_batch()))
    assert set(logs) == {"train_loss/loc_2d", "train_loss/primary"}
    np.testing.assert_allclose(float(logs["train_loss/loc_2d"]),
                               float(j_losses["loc_2d"]), rtol=1e-4)
    ref = flax_to_state_dict(j_grads["movements"])
    tree = state.params["movements"]
    assert set(tree) == set(ref)
    for k, p in tree.items():
        _scaled_close(p.grad.numpy(), ref[k].numpy(), msg=k)


def test_autoencoder_eval_metrics_match_jax():
    """An eval pass's losses and metrics (MSE, PCKhn@01, PCK@005), and the
    baseline's (the same three and MJR of the inputs as predictions)."""
    j_params, _, _, j_eval, j_metrics, j_initial = _jax_flow_case()
    flow = _port_flow("plain")
    params = import_flow_params(j_params, device="cpu")
    batch = _to_torch(_batch())
    losses, preds, targets = flow.eval_step(params, batch)
    np.testing.assert_allclose(float(losses["loc_2d"]),
                               float(j_eval["loc_2d"]), rtol=1e-4)
    metrics = flow.metrics.compute(flow.metrics.update(
        flow.metrics.init_state("cpu"), preds, targets))
    assert set(metrics) == set(j_metrics) == {"MSE", "PCKhn@01", "PCK@005"}
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    inputs, targets, _ = batch
    initial = flow.initial_metrics.compute(flow.initial_metrics.update(
        flow.initial_metrics.init_state("cpu"),
        flow.initial_preds(inputs, targets), targets))
    assert set(initial) == set(j_initial)
    for k, v in j_initial.items():
        np.testing.assert_allclose(float(initial[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    assert 0.0 < float(initial["MJR"]) < 1.0


def test_teacher_forcing_ratio_decays_each_epoch():
    model = _port_model("clip_force_1")
    model.teacher_force_drop = 0.25
    flow = AutoencoderFlow(model, device="cpu")
    assert not flow.on_epoch_start(0) and model.teacher_force_ratio == 1.0
    assert flow.on_epoch_start(1) and model.teacher_force_ratio == 0.75
    for epoch in range(2, 7):
        flow.on_epoch_start(epoch)
    assert model.teacher_force_ratio == 0.0
    assert not flow.on_epoch_start(7)
    still = AutoencoderFlow(_port_model("Seq2SeqEmbeddings"), device="cpu")
    assert not still.on_epoch_start(3)


def test_cli_fits_config_2(tmp_path):
    """A 2-step CPU fit of BASELINE config 2's flow through the CLI, the
    encoder on the fused route, then its checkpoint evaluated."""
    common = ["--flow=autoencoder", "--movements_model_name="
              "Seq2SeqEmbeddings", "--movements_output_type=pose_2d",
              "--loss_modes", "loc_2d", "--rnn_kernel", "fused",
              "--hidden_size=8", "--single_joint_embeddings_size=4",
              "--batch_size=2", "--clip_length=4", "--val_set_size=4",
              "--test_set_size=2", "--device=cpu", f"--root_dir={tmp_path}"]
    out = modeling.main(common + ["--max_epochs=1", "--limit_train_batches=2",
                                  "--log_every_n_steps=1", "--run_name=ae"])
    flow = out["flow"]
    assert isinstance(flow, AutoencoderFlow)
    model = flow.movements_model
    assert (type(model).__name__, model.rnn_kernel, model.hidden_size,
            model.num_layers, model.p_dropout,
            model.movements_output_type) == (
        "Seq2SeqEmbeddings", "fused", 8, 2, 0.2, MOT.pose_2d)
    assert out["trainer"].state.step == 2
    val = out["val_metrics"]
    for k in ("val_loss/loc_2d", "val_MSE", "val_PCKhn@01", "val_PCK@005"):
        assert np.isfinite(val[k]), k
    ckpt = tmp_path / "logs" / "autoencoder" / "ae" / "checkpoints" / "last"
    tested = modeling.main(common + ["--mode=test", f"--ckpt_path={ckpt}",
                                     "--run_name=ae_test"])
    assert np.isfinite(tested["test_metrics"]["test_MSE"])
