"""The running statistics through the port's training state, checkpoints,
evaluation and serving; and reference torch checkpoints through
``Trainer.restore_torch`` and the CLI, on the CPU.

- A VideoPose3D fit (BatchNorm at momentum 0.9): the statistics never
  require grad, stay out of AdamW, the clip, ``param_counts`` and the
  anomaly check, move in training, and come back bit for bit from a
  checkpoint, a weights-only restore included; ``eval_step``,
  ``Trainer.evaluate`` and ``make_inference_fn`` read them.
- ``restore_torch`` on ``.pt``, ``.pth`` and Lightning-style ``.ckpt``
  files written from torch modules in the reference architectures' state
  layouts (as ``tests/models/test_torch_import.py`` builds them): the
  port's model then matches the JAX package's on the same file, through
  the JAX importers that its ``restore_torch`` runs (bar 1e-5 of max
  |out|). Another model name raises.
- The CLI: a fit of VideoPose3D at a small width, its own ``.pt`` archive
  evaluated, and a reference ``.ckpt`` loaded by ``--ckpt_path``.
"""
import math

import jax
import numpy as np
import pytest
import torch
from torch import nn
from torch.func import functional_call

from pedestrians_video_2_carla_tpu.flows.output_types import \
    MovementsModelOutputType as JMOT
from pedestrians_video_2_carla_tpu.models.movements import \
    MOVEMENTS_MODELS as J_MODELS
from pedestrians_video_2_carla_tpu.models.torch_import import (
    IMPORTERS as J_IMPORTERS, load_torch_checkpoint as j_load)
from tests.models.test_torch_import import _build_mini_poseformer

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
    Carla2D3DDataModule
from pedestrians_video_2_carla_torch.flows.autoencoder import AutoencoderFlow
from pedestrians_video_2_carla_torch.flows.output_types import \
    MovementsModelOutputType as MOT
from pedestrians_video_2_carla_torch.flows.pose_lifting import PoseLiftingFlow
from pedestrians_video_2_carla_torch.models.movements import MOVEMENTS_MODELS
from pedestrians_video_2_carla_torch.models.torch_import import (
    IMPORTERS, import_torch_checkpoint)
from pedestrians_video_2_carla_torch.serving import make_inference_fn
from pedestrians_video_2_carla_torch.training.trainer import (Trainer,
                                                              TrainerConfig)
from .torch_threads import limit_torch_threads

limit_torch_threads()

J, B, L = 26, 2, 5
SMALL_VP = {"filter_widths": (3, 3), "channels": 16}


def _vp_flow(**kwargs):
    model = MOVEMENTS_MODELS["VideoPose3D"](
        generator=torch.Generator().manual_seed(0), **SMALL_VP)
    return PoseLiftingFlow(model, loss_modes=["loc_2d_3d"], device="cpu",
                           **kwargs)


def _trainer(flow, tmp_path, name="run"):
    dm = Carla2D3DDataModule(batch_size=B, clip_length=L, val_set_size=2 * B,
                             test_set_size=B, device="cpu")
    return Trainer(flow, dm, TrainerConfig(
        max_epochs=1, limit_train_batches=3, log_every_n_steps=1,
        detect_anomaly=True, logs_dir=str(tmp_path), run_name=name,
        device="cpu"))


def _stats(tree):
    return {k: v for k, v in tree.items() if "running_" in k}


def test_running_statistics_through_training_and_checkpoints(tmp_path):
    flow = _vp_flow(gradient_clip_val=0.5)
    start = _stats(flow.init_params()["movements"])
    assert len(start) == 2 * 3                    # 3 BatchNorms
    trainer = _trainer(flow, tmp_path)
    state = trainer.fit()
    tree = state.params["movements"]
    stats = _stats(tree)
    assert set(stats) == set(start)
    grouped = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    for k, v in stats.items():
        assert not v.requires_grad and v.grad is None and id(v) not in grouped
        assert not torch.equal(v, start[k]), k    # training moved them
    assert all(v.requires_grad and id(v) in grouped
               for k, v in tree.items() if k not in stats)
    n_params = sum(p.numel() for p in flow.movements_model.parameters())
    assert flow.param_counts(state)["movements"] == n_params

    # evaluation reads them: other statistics, other losses
    batch = next(trainer.dm.val_batches())
    losses, preds, _ = flow.eval_step(state.params, batch)
    val = trainer.evaluate("val")
    reset = {name: {k: (torch.zeros_like(v) if k.endswith("mean") else
                        torch.ones_like(v)) if "running_" in k else v
                    for k, v in t.items()}
             for name, t in state.params.items()}
    other, _, _ = flow.eval_step(reset, batch)
    assert float(other["loc_2d_3d"]) != float(losses["loc_2d_3d"])
    # serving too: the closure's outputs are eval_step's
    inputs, _, meta = batch
    served = make_inference_fn(flow, state.params)(inputs,
                                                   meta["age_gender_idx"])
    assert torch.equal(served["absolute_pose_loc"],
                       preds["absolute_pose_loc"])

    # a non-finite statistic is not a parameter for the anomaly check
    with torch.no_grad():
        saved = tree["BatchNorm_0.running_var"].clone()
        tree["BatchNorm_0.running_var"][0] = math.inf
        trainer._check_anomaly({"train_loss/primary": 1.0}, 1)
        tree["BatchNorm_0.running_var"].copy_(saved)

    # the checkpoint holds them; a full and a weights-only restore give
    # them back bit for bit, and the restored state evaluates the same
    last = str(tmp_path / "run" / "checkpoints" / "last")
    for weights_only in (False, True):
        fresh = flow.init_state()
        assert not torch.equal(_stats(fresh.params["movements"])[
            "BatchNorm_0.running_mean"], stats["BatchNorm_0.running_mean"])
        trainer.checkpoints.restore(fresh, last, weights_only=weights_only)
        for k, v in tree.items():
            assert torch.equal(fresh.params["movements"][k], v), k
        assert not any(v.requires_grad for v in _stats(
            fresh.params["movements"]).values())
        again, _, _ = flow.eval_step(fresh.params, batch)
        assert torch.equal(again["loc_2d_3d"], losses["loc_2d_3d"])
    restored = _trainer(_vp_flow(), tmp_path, "restored")
    restored.restore(last, weights_only=True)
    assert restored.evaluate("val") == val


def test_training_step_updates_running_statistics_in_place():
    """One step: the statistics are the same tensors as before it, and the
    expand conv's BatchNorm moved by flax's rule at momentum 0.9 (the
    batch's mean and biased variance); evaluation does not move them."""
    flow = _vp_flow()
    state = flow.init_state()
    tree = state.params["movements"]
    before = {k: v.clone() for k, v in _stats(tree).items()}
    ids = {k: id(v) for k, v in _stats(tree).items()}
    dm = Carla2D3DDataModule(batch_size=B, clip_length=L, device="cpu")
    flow.eval_step(state.params, next(dm.val_batches()))
    assert all(torch.equal(tree[k], v) for k, v in before.items())
    batch = next(dm.train_batches())
    frames = torch.arange(-4, L + 4).clamp(0, L - 1)
    with torch.no_grad():
        h = functional_call(flow.movements_model.expand_conv, {
            "weight": tree["expand_conv.weight"]},
            (batch[0][..., :2].reshape(B, L, -1)[:, frames],))
    flow.training_step(state, batch)
    assert {k: id(v) for k, v in _stats(tree).items()} == ids
    for k, v in before.items():
        assert not torch.equal(tree[k], v), k
    mean = h.mean((0, 1))
    var = (h * h).mean((0, 1)) - mean * mean
    torch.testing.assert_close(tree["BatchNorm_0.running_mean"], 0.1 * mean,
                               rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(tree["BatchNorm_0.running_var"],
                               0.9 + 0.1 * var, rtol=1e-5, atol=1e-7)


# -- reference torch checkpoints ----------------------------------------------

def _reference_linear_ae():
    class LinearAE(nn.Module):
        def __init__(self):
            super().__init__()
            in_size, out_size = J * 2, J * 6
            self.__encoder = nn.Sequential(
                nn.Linear(in_size, in_size // 2), nn.ReLU(),
                nn.Linear(in_size // 2, in_size // 4), nn.ReLU(),
                nn.Linear(in_size // 4, in_size // 8), nn.ReLU())
            self.__decoder = nn.Sequential(
                nn.Linear(in_size // 8, out_size // 4), nn.ReLU(),
                nn.Linear(out_size // 4, out_size // 2), nn.ReLU(),
                nn.Linear(out_size // 2, out_size))
    return LinearAE()


def _reference_seq2seq_embeddings(E=4, H=8):
    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.rnn = nn.LSTM(J * E, H, num_layers=2)

    class Decoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.rnn = nn.LSTM(J * 2, H, num_layers=2)
            self.fc_out = nn.Linear(H, J * 2)

    class Seq2SeqEmbeddings(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = Encoder()
            self.decoder = Decoder()
            self.embeddings = nn.ModuleList(
                [nn.Linear(2, E) for _ in range(J)])
    return Seq2SeqEmbeddings()


def _reference_temporal_model(C=16, widths=(3, 3)):
    class TemporalModel(nn.Module):
        def __init__(self):
            super().__init__()
            self.expand_conv = nn.Conv1d(J * 2, C, widths[0], bias=False)
            self.expand_bn = nn.BatchNorm1d(C, momentum=0.1)
            convs, dilation = [], widths[0]
            for w in widths[1:]:
                convs += [nn.Conv1d(C, C, w, dilation=dilation, bias=False),
                          nn.Conv1d(C, C, 1, bias=False)]
                dilation *= w
            self.layers_conv = nn.ModuleList(convs)
            self.layers_bn = nn.ModuleList([nn.BatchNorm1d(C, momentum=0.1)
                                            for _ in convs])
            self.shrink = nn.Conv1d(C, J * 3, 1)
    model = TemporalModel()
    for bn in (model.expand_bn, *model.layers_bn):   # statistics away from
        bn.running_mean.normal_()                    # 0 / 1
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.data.uniform_(0.5, 1.5)
        bn.bias.data.normal_()
    return model


PF = {"emb": 8, "heads": 2, "depth": 4, "rf": 3}

#: model name -> (reference module, the port's and the JAX model's sizes,
#: the port's flow)
REFERENCES = {
    "LinearAE": (_reference_linear_ae, {}, PoseLiftingFlow),
    "Seq2SeqEmbeddings": (_reference_seq2seq_embeddings,
                          {"hidden_size": 8,
                           "single_joint_embeddings_size": 4,
                           "p_dropout": 0.0,
                           "movements_output_type": "pose_2d"},
                          AutoencoderFlow),
    "VideoPose3D": (_reference_temporal_model, SMALL_VP, PoseLiftingFlow),
    "PoseFormer": (lambda: _build_mini_poseformer(**PF),
                   {"clip_length": L, "receptive_frames": PF["rf"],
                    "single_joint_embeddings_size": PF["emb"],
                    "depth": PF["depth"], "num_heads": PF["heads"]},
                   PoseLiftingFlow),
}


def _write(reference, path):
    """A raw ``state_dict`` (``.pt``, ``.pth``) or a Lightning checkpoint
    with the movements model under ``movements_model.`` (``.ckpt``)."""
    sd = reference.state_dict()
    if path.suffix == ".ckpt":
        sd = {"state_dict": {f"movements_model.{k}": v for k, v in sd.items()},
              "epoch": 3, "global_step": 120}
    torch.save(sd, path)


def _sizes(sizes, mot):
    return {k: (mot[v] if k == "movements_output_type" else v)
            for k, v in sizes.items()}


@pytest.mark.parametrize("name,suffix", [
    ("LinearAE", ".ckpt"), ("LinearAE", ".pth"),
    ("Seq2SeqEmbeddings", ".ckpt"), ("VideoPose3D", ".ckpt"),
    ("VideoPose3D", ".pt"), ("PoseFormer", ".ckpt")])
def test_restore_torch_matches_jax(name, suffix, tmp_path):
    torch.manual_seed(3)
    make, sizes, flow_cls = REFERENCES[name]
    path = tmp_path / f"reference{suffix}"
    _write(make(), path)
    x = np.random.default_rng(4).standard_normal((B, L, J, 2)).astype(
        np.float32)

    # the JAX package's restore_torch: its loader and importer
    sd = j_load(str(path), prefix="movements_model.") or j_load(str(path))
    out = J_IMPORTERS[name](sd)
    params, stats = out if isinstance(out, tuple) else (out, None)
    variables = {"params": params, **({"batch_stats": stats} if stats
                                      else {})}
    ref = np.asarray(J_MODELS[name](**_sizes(sizes, JMOT)).apply(
        variables, x, training=False, rngs={"dropout": jax.random.PRNGKey(0)}))

    flow = flow_cls(MOVEMENTS_MODELS[name](**_sizes(sizes, MOT)),
                    device="cpu")
    trainer = _trainer(flow, tmp_path)
    trainer.restore_torch(str(path), name)
    assert trainer.state.step == 0
    tree = trainer.state.params["movements"]
    assert tree.keys() == flow.movements_model.state_dict().keys()
    with torch.no_grad():
        got = functional_call(flow.movements_model, tree,
                              (torch.from_numpy(x),))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    if name == "VideoPose3D":   # the reference's statistics, as they were
        np.testing.assert_array_equal(
            tree["BatchNorm_2.running_var"].numpy(),
            sd["layers_bn.1.running_var"])


def test_restore_torch_refuses_what_it_cannot_map(tmp_path):
    path = tmp_path / "reference.pt"
    _write(_reference_linear_ae(), path)
    assert set(IMPORTERS) == set(J_IMPORTERS)
    with pytest.raises(ValueError, match="no torch weight importer"):
        import_torch_checkpoint(str(path), "Baseline3DPose")
    # a LinearAE file does not fit a VideoPose3D flow
    trainer = _trainer(_vp_flow(), tmp_path)
    with pytest.raises((ValueError, KeyError)):
        trainer.restore_torch(str(path), "VideoPose3D")


def test_cli_fits_video_pose_3d_and_loads_checkpoints(tmp_path):
    """A 2-step CPU fit of VideoPose3D through the CLI (16 channels); its
    own ``last.pt`` evaluated in test mode (the port's archive, weights
    only); then a reference TemporalModel ``.ckpt`` through
    ``--ckpt_path``."""
    common = ["--movements_model_name=VideoPose3D", "--channels=16",
              "--loss_modes", "loc_2d_3d", "--batch_size=2",
              "--clip_length=5", "--val_set_size=2", "--test_set_size=2",
              "--device=cpu", f"--root_dir={tmp_path}"]
    out = modeling.main(common + ["--max_epochs=1", "--limit_train_batches=2",
                                  "--log_every_n_steps=1", "--run_name=vp"])
    model = out["flow"].movements_model
    assert (type(model).__name__, model.channels, model.filter_widths,
            model.p_dropout) == ("VideoPose3D", 16, (3, 3, 3, 3), 0.25)
    assert out["trainer"].state.step == 2
    assert math.isfinite(out["val_metrics"]["val_loss/loc_2d_3d"])
    archive = tmp_path / "logs" / "pose_lifting" / "vp" / "checkpoints" \
        / "last.pt"
    tested = modeling.main(common + ["--mode=test", f"--ckpt_path={archive}",
                                     "--run_name=vp_test"])
    trained = out["trainer"].state.params["movements"]
    for k, v in tested["trainer"].state.params["movements"].items():
        assert torch.equal(v, trained[k]), k

    reference = tmp_path / "temporal.ckpt"
    torch.manual_seed(5)
    _write(_reference_temporal_model(widths=(3, 3, 3, 3)), reference)
    loaded = modeling.main(common + ["--mode=test",
                                     f"--ckpt_path={reference}",
                                     "--run_name=vp_ref"])
    tree = loaded["trainer"].state.params["movements"]
    expected = import_torch_checkpoint(str(reference), "VideoPose3D")
    assert set(tree) == set(expected)
    for k, v in expected.items():
        assert torch.equal(tree[k], v), k
    assert math.isfinite(loaded["test_metrics"]["test_loss/loc_2d_3d"])
