"""Port parity for the pose-lifting training slice, on the CPU: the trainable
fused FK + projection (the plain version the CPU runs, against the JAX
package's ``fused_projection_train`` with its Pallas forward and backward in
interpret mode), ``training_step`` against the JAX flow's with the same
weights and batch, the optimizer against ``optax.adamw``, checkpoints, the
trainer and the CLI."""
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pedestrians_video_2_carla_tpu.data.carla import carla_2d3d as JD
from pedestrians_video_2_carla_tpu.flows.pose_lifting import \
    PoseLiftingFlow as JPoseLiftingFlow
from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
from pedestrians_video_2_carla_tpu.losses import primary_loss as j_primary
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.movements.linear_ae import \
    LinearAE as JLinearAE
from pedestrians_video_2_carla_tpu.ops import camera as JC
from pedestrians_video_2_carla_tpu.ops.pallas.fused_projection import \
    fused_projection_train as j_fused_projection_train
from pedestrians_video_2_carla_tpu.skeletons.carla import reference_poses_tensor

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
    Carla2D3DDataModule
from pedestrians_video_2_carla_torch.flows.pose_lifting import PoseLiftingFlow
from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
from pedestrians_video_2_carla_torch.models.jax_import import (
    flax_to_state_dict, import_flow_params)
from pedestrians_video_2_carla_torch.models.movements.linear_ae import LinearAE
from pedestrians_video_2_carla_torch.ops import camera as TC
from pedestrians_video_2_carla_torch.ops import fused_projection as FP
from pedestrians_video_2_carla_torch.training.checkpoint import \
    CheckpointManager
from pedestrians_video_2_carla_torch.training.trainer import (Trainer,
                                                              TrainerConfig)

from .ops.np_reference import random_rotation_matrices
from .torch_threads import limit_torch_threads

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 4, 4
LR = 1e-3


def _scaled_close(port, ref, msg="", atol=1e-5):
    """The JAX package's kernel-gradient bar (test_pallas_fused.py): each
    cotangent divided by its largest magnitude, rtol 1e-4, atol 1e-5."""
    port, ref = np.asarray(port), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-8)
    np.testing.assert_allclose(port / scale, ref / scale, rtol=1e-4,
                               atol=atol, err_msg=msg)


# -- the trainable fused FK + projection ------------------------------------

def _loss_terms(proj, abs_loc, lib):
    """The loss of the JAX package's backward-kernel test: both outputs."""
    return lib.sum(lib.sin(proj[..., :2] * 0.01)) + lib.sum(abs_loc ** 2)


@functools.lru_cache(maxsize=None)
def _jax_train_case(batch, clip):
    """Seeded inputs, and the JAX kernel's outputs and the gradients of all
    three inputs through its Pallas backward. Interpret mode takes seconds
    per call, so the tests of one shape share this call."""
    rng = np.random.default_rng(1000 * batch + clip)
    agi = rng.integers(0, 4, size=batch)
    locs, rots = reference_poses_tensor()
    changes = random_rotation_matrices(rng, (batch, clip, 26)).astype(
        np.float32)
    inputs = (changes, np.ascontiguousarray(locs[agi]),
              np.ascontiguousarray(rots[agi]))
    cam = JC.make_camera()

    def loss(c, l, r):
        proj, abs_loc = j_fused_projection_train(c, l, r, cam)
        return _loss_terms(proj, abs_loc, jnp), (proj, abs_loc)
    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, inputs))
    return inputs, jax.device_get(outs), jax.device_get(grads)


#: ragged batches (the JAX kernel pads B to a block of 8), two frames (frame
#: 0 takes rel_rot as S_prev, the last frame a zero carry) and one frame
SHAPES = [(5, 2), (3, 1)]
SHAPE_IDS = ["B5_L2", "B3_L1"]


@pytest.mark.parametrize("batch,clip", SHAPES, ids=SHAPE_IDS)
def test_train_forward_matches_jax(batch, clip):
    inputs, (j_proj, j_abs), _ = _jax_train_case(batch, clip)
    proj, abs_loc = FP.fused_projection_train(
        *map(torch.from_numpy, inputs), TC.make_camera())
    assert proj.shape == abs_loc.shape == (batch, clip, 26, 3)
    np.testing.assert_allclose(proj.numpy(), j_proj, atol=1e-3)   # pixels
    np.testing.assert_allclose(abs_loc.numpy(), j_abs, atol=1e-5)
    ref_proj, ref_abs = FP.fused_projection_train_reference(
        *map(torch.from_numpy, inputs), TC.make_camera())
    assert torch.equal(proj, ref_proj) and torch.equal(abs_loc, ref_abs)


@pytest.mark.parametrize("batch,clip", SHAPES, ids=SHAPE_IDS)
def test_train_gradients_match_jax_backward_kernel(batch, clip):
    inputs, _, j_grads = _jax_train_case(batch, clip)
    tensors = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    proj, abs_loc = FP.fused_projection_train(*tensors, TC.make_camera())
    _loss_terms(proj, abs_loc, torch).backward()
    for name, t, ref in zip(("pose_changes", "rel_loc", "rel_rot"), tensors,
                            j_grads):
        _scaled_close(t.grad, ref, msg=name)


def test_train_unused_output_gets_a_zero_cotangent(rng):
    """Autograd hands no cotangent for an output no loss used (and views of
    the other): the wrapper takes it as zeros, as the kernel needs."""
    locs, rots = reference_poses_tensor()
    agi = rng.integers(0, 4, size=2)
    tensors = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
               for a in (random_rotation_matrices(rng, (2, 3, 26)).astype(
                   np.float32), locs[agi], rots[agi])]
    proj, _ = FP.fused_projection_train(*tensors, TC.make_camera())
    proj[..., :2].sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in tensors]
    FP.fused_projection_train_reference(
        *ref, TC.make_camera())[0][..., :2].sum().backward()
    for t, r in zip(tensors, ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=0, atol=0)


def test_train_kernel_wrappers_never_run_on_the_cpu(rng):
    locs, rots = reference_poses_tensor()
    agi = rng.integers(0, 4, size=2)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        random_rotation_matrices(rng, (2, 3, 26)).astype(np.float32),
        locs[agi], rots[agi])]
    with pytest.raises(ValueError, match="CUDA"):
        FP.fused_projection_train_cuda_fwd(*args, TC.make_camera())
    g = torch.zeros((2, 3, 26, 3))
    with pytest.raises(ValueError, match="CUDA"):
        FP.fused_projection_train_cuda_bwd(
            *args, torch.zeros((2, 3, 26, 9)), g, g, TC.make_camera())
    assert FP.fused_projection_train_cuda_fwd.launches == 0
    assert FP.fused_projection_train_cuda_bwd.launches == 0


def test_train_library_is_its_own():
    # the training kernels get their own library; the serving one keeps
    # its path
    serve, train = FP.library_path(), FP.library_path(FP._TRAIN_SOURCE)
    assert serve.name.startswith("fused_projection-")
    assert train.name.startswith("fused_projection_train-")
    assert serve.parent == train.parent == FP.BUILD_DIR


# -- training_step against the JAX flow --------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step_case(kernel):
    """A JAX flow's initial params, a batch, and one training step: the body
    of the flow's ``training_step`` (``jax.value_and_grad`` over its own
    ``_inner_step``, ``_compute_losses`` and ``primary_loss``, then its
    optimizer's update), keeping the gradients it takes. One jitted call
    with the kernels in interpret mode takes seconds."""
    batch = jax.device_get(JD.generate_batch(
        jax.random.PRNGKey(5), JD.Carla2D3DConfig(batch_size=B,
                                                  clip_length=L)))
    flow = JPoseLiftingFlow(movements_model=JLinearAE(),
                            loss_modes=[JLossModes.loc_2d_3d],
                            movements_optimizer=JOptimizerSettings(lr=LR),
                            projection_kernel=kernel)
    state = flow.init_state(jax.random.PRNGKey(1), batch)

    def loss_fn(params):
        sliced, _ = flow._inner_step(params, state.mutables, batch,
                                     training=True, rngs=None)
        losses = flow._compute_losses(sliced, sliced["targets"])
        return j_primary(losses, flow.requested_loss_modes)[1], losses
    (primary, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params)
    updates, _ = flow._tx.update(grads, state.opt_state, state.params,
                                 value=primary)
    new_params = optax.apply_updates(state.params, updates)
    logs = {f"train_loss/{k}": v for k, v in losses.items()}
    logs["train_loss/primary"] = primary
    return jax.device_get((state.params, batch, grads, new_params, logs))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


#: the seed of the port flows' models: the CLI seeds its models too
#: (``modeling.main``), and a model drawn from torch's global RNG would
#: depend on the tests the worker ran before
MODEL_SEED = 0


def _port_flow(kernel, **kw):
    return PoseLiftingFlow(
        LinearAE(generator=torch.Generator().manual_seed(MODEL_SEED)),
        loss_modes=["loc_2d_3d"],
        movements_optimizer=OptimizerSettings(lr=LR),
        projection_kernel=kernel, device="cpu", **kw)


#: the scaled gradient atol of each pair. Both sides of "fused_train" <->
#: "pallas_train" accumulate the rotations over the clip in a sequential
#: loop, and hold the kernels' 1e-5. JAX's "xla" accumulates them with an
#: associative scan, which rounds in another order: on this batch its
#: first-layer gradients differ from the port's by 2.9e-5 of their largest
#: magnitude, and from JAX's own "pallas_train" route by 1.1e-5.
GRAD_ATOL = {"fused_train": 1e-5, "plain": 5e-5}


@pytest.mark.parametrize("port_kernel,jax_kernel",
                         [("fused_train", "pallas_train"), ("plain", "xla")])
def test_training_step_matches_jax(port_kernel, jax_kernel):
    j_params, j_batch, j_grads, j_new, j_logs = _jax_step_case(jax_kernel)
    flow = _port_flow(port_kernel)
    state = flow.init_state(import_flow_params(j_params, device="cpu"))
    state, logs = flow.training_step(state, _to_torch(j_batch))
    assert state.step == 1

    assert set(logs) == set(j_logs) == {
        "train_loss/loc_2d", "train_loss/loc_3d", "train_loss/loc_2d_3d",
        "train_loss/primary"}
    for k, ref in j_logs.items():
        np.testing.assert_allclose(float(logs[k]), ref, rtol=1e-4, err_msg=k)

    for name, tree in state.params.items():
        ref_grads = flax_to_state_dict(j_grads[name])
        ref_new = flax_to_state_dict(j_new[name])
        assert set(tree) == set(ref_grads) == set(ref_new)
        for k, p in tree.items():
            g_ref = ref_grads[k].numpy()
            g = np.zeros_like(g_ref) if p.grad is None else p.grad.numpy()
            _scaled_close(g, g_ref, msg=f"grad {name}.{k}",
                          atol=GRAD_ATOL[port_kernel])
            # Adam's first step is lr * g / (|g| + eps), about lr * sign(g):
            # where g is tiny against the leaf's largest, float32 rounding
            # can flip its sign between the frameworks, and the new params
            # then differ by up to 2 lr (plus float32 rounding of p)
            diff = np.abs(p.detach().numpy() - ref_new[k].numpy())
            big = np.abs(g_ref) > 1e-4 * np.abs(g_ref).max()
            assert diff[big].max(initial=0.0) <= 1e-5, f"{name}.{k}"
            assert diff[~big].max(initial=0.0) <= 2 * LR + 1e-6, \
                f"{name}.{k}"


def test_training_step_updates_in_place_and_keeps_grads():
    flow = _port_flow("fused_train")
    state = flow.init_state()
    before = {k: v.detach().clone() for k, v in
              state.params["movements"].items()}
    batch = next(Carla2D3DDataModule(batch_size=2, clip_length=3,
                                     device="cpu").train_batches())
    same, logs = flow.training_step(state, batch)
    assert same is state and state.step == 1
    # every trained leaf has a gradient, and AdamW moves each whose
    # gradient is not all zero. LinearAE's bottleneck is 52 // 8 = 6 ReLU
    # units: on a batch of 6 frames they may all be dead for a draw of the
    # weights, and then the layers before them get exactly zero gradients,
    # and a first Adam step of exactly zero (the JAX model does the same)
    tree = state.params["movements"]
    for k, v in tree.items():
        assert v.grad is not None, k
        if v.grad.any():
            assert not torch.equal(v.detach(), before[k]), k
    # the head always learns: its bias's gradient is the mean output error
    assert tree["Dense_5.bias"].grad.any()
    for k in ("Dense_5.weight", "Dense_5.bias"):
        assert not torch.equal(tree[k].detach(), before[k]), k
    assert all(not v.requires_grad for v in logs.values())
    assert flow.param_counts(state) == {
        "movements": sum(v.numel() for v in before.values()),
        "trajectory": 1}
    assert flow.current_lrs(state) == {"lr-movements": LR,
                                       "lr-trajectory": 1e-4}


def test_flow_refuses_what_is_not_ported():
    """bf16 is ported: ``"bf16"`` and ``"16"`` build a bf16 flow, another
    precision raises; clipping and the LR schedules are:
    tests/test_torch_train_options.py holds them against optax. The
    heatmaps loss is ported too: a pose-lifting flow takes it, as the JAX
    flow does, and its step then computes no loss and raises the JAX
    flow's error (tests/test_torch_pose_estimation.py trains with it)."""
    for precision in ("bf16", "16"):
        assert _port_flow("plain", precision=precision).precision == "bf16"
    with pytest.raises(ValueError, match="precision"):
        _port_flow("plain", precision="fp8")
    heatmaps = _port_flow("plain")
    heatmaps = PoseLiftingFlow(heatmaps.movements_model, device="cpu",
                               loss_modes=["heatmaps"])
    batch = next(Carla2D3DDataModule(batch_size=2, clip_length=3,
                                     device="cpu").train_batches())
    with pytest.raises(RuntimeError, match="Couldn't calculate any loss"):
        heatmaps.training_step(heatmaps.init_state(), batch)
    flow = PoseLiftingFlow(
        LinearAE(), device="cpu", gradient_clip_val=1.0,
        movements_optimizer=OptimizerSettings(enable_lr_scheduler=True))
    state = flow.init_state()
    assert flow.gradient_clip_val == 1.0
    assert list(state.schedules) == ["movements"]


# -- the optimizer -------------------------------------------------------------

@pytest.mark.parametrize("route", ["make", "flow"])
def test_adamw_matches_optax(rng, route):
    """Five steps of one gradient sequence through the port's AdamW and
    ``optax.adamw``: ``OptimizerSettings.make`` over one tensor, and the
    optimizer ``training_step`` steps (``init_state``: a parameter group per
    model, movements at lr 1e-3, trajectory at the default 1e-4)."""
    def away_from_zero(shape):
        # rtol compares the params, and an update of about lr must not
        # dwarf the value
        return (rng.uniform(0.5, 2.0, shape)
                * rng.choice([-1, 1], shape)).astype(np.float32)

    if route == "make":
        param = torch.from_numpy(away_from_zero((7, 5))).requires_grad_(True)
        trees = {"params": {"w": param}}
        opt = OptimizerSettings(lr=LR).make([param])
        settings = {"params": JOptimizerSettings(lr=LR)}
    else:
        flow = PoseLiftingFlow(LinearAE(), device="cpu",
                               movements_optimizer=OptimizerSettings(lr=LR))
        state = flow.init_state()
        with torch.no_grad():
            for tree in state.params.values():
                for v in tree.values():
                    v.copy_(torch.from_numpy(away_from_zero(tuple(v.shape))))
        trees, opt = state.params, state.optimizer
        settings = {"movements": JOptimizerSettings(lr=LR),
                    "trajectory": JOptimizerSettings()}
    assert sum(v.numel() for tree in trees.values() for v in tree.values())
    txs = {n: settings[n].make() for n in trees}
    j_params = {n: {k: jnp.asarray(v.detach().numpy())
                    for k, v in tree.items()} for n, tree in trees.items()}
    j_states = {n: txs[n].init(j_params[n]) for n in trees}
    for scale in (1.0, 0.1, 3.0, 1e-3, 0.5):
        for n, tree in trees.items():
            grads = {k: (rng.standard_normal(tuple(v.shape)) * scale)
                     .astype(np.float32) for k, v in tree.items()}
            for k, v in tree.items():
                v.grad = torch.from_numpy(grads[k])
            updates, j_states[n] = txs[n].update(
                {k: jnp.asarray(g) for k, g in grads.items()}, j_states[n],
                j_params[n])
            j_params[n] = optax.apply_updates(j_params[n], updates)
        opt.step()
        for n, tree in trees.items():
            for k, v in tree.items():
                np.testing.assert_allclose(
                    v.detach().numpy(), np.asarray(j_params[n][k]),
                    rtol=1e-6, err_msg=f"{n}.{k}")


def test_optimizer_settings_match_jax():
    kwargs = {"movements_lr": None, "movements_weight_decay": 1e-3}
    for enable in (False, True):
        port = OptimizerSettings(enable_lr_scheduler=enable)
        ref = JOptimizerSettings(enable_lr_scheduler=enable)
        assert port.learning_rate == ref.learning_rate
        assert port.hparams("m") == ref.hparams("m")
    assert OptimizerSettings.from_kwargs("movements", kwargs) \
        .hparams("movements") == JOptimizerSettings.from_kwargs(
            "movements", kwargs).hparams("movements")
    scheduled = OptimizerSettings(enable_lr_scheduler=True)
    opt = scheduled.make([torch.zeros(1, requires_grad=True)])
    assert opt.param_groups[0]["lr"] == 5e-2
    assert scheduled.schedule(4).steps_per_epoch == 4
    assert OptimizerSettings().schedule() is None


# -- checkpoints ---------------------------------------------------------------

def _batches(n, seed=0):
    dm = Carla2D3DDataModule(batch_size=2, clip_length=3, device="cpu")
    stream = dm.train_batches(seed)
    return [next(stream) for _ in range(n)]


def _flat(state):
    return {f"{n}.{k}": v.detach().clone()
            for n, tree in state.params.items() for k, v in tree.items()}


def test_checkpoint_round_trip_is_exact(tmp_path):
    flow = _port_flow("fused_train")
    state = flow.init_state()
    b0, b1 = _batches(2)
    flow.training_step(state, b0)
    flow.training_step(state, b1)
    manager = CheckpointManager(str(tmp_path))
    assert manager.save(state, {"val_loss/primary": 0.5}, step=2)
    assert not manager.save(state, {"val_loss/primary": 0.7}, step=3)
    assert manager.save(state, {"val_loss/primary": 0.25}, step=4)
    with open(tmp_path / "best.json") as f:
        best = json.load(f)
    assert best["step"] == 4 and best["val_loss/primary"] == 0.25
    assert sorted(os.listdir(tmp_path)) == ["best-step4.pt", "best.json",
                                            "last.pt"]

    fresh = flow.init_state()
    manager.restore(fresh, str(tmp_path / "last"))
    assert fresh.step == 2
    for k, v in _flat(state).items():
        assert torch.equal(_flat(fresh)[k], v), k
    saved, loaded = state.optimizer.state_dict(), \
        fresh.optimizer.state_dict()
    assert saved["param_groups"] == loaded["param_groups"]
    for i, s in saved["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(loaded["state"][i][k]),
                               torch.as_tensor(v)), (i, k)

    weights = flow.init_state()
    manager.restore(weights, weights_only=True)  # the best, weights only
    assert weights.step == 0 and not weights.optimizer.state
    assert torch.equal(_flat(weights)["movements.Dense_0.weight"],
                       _flat(state)["movements.Dense_0.weight"])


def test_resumed_training_takes_the_same_next_step(tmp_path):
    b0, b1, b2 = _batches(3)
    flow = _port_flow("fused_train")
    straight = flow.init_state()
    flow.training_step(straight, b0)
    flow.training_step(straight, b1)
    CheckpointManager(str(tmp_path)).save(straight, {}, step=2)
    _, logs = flow.training_step(straight, b2)

    resumed = flow.init_state()
    CheckpointManager(str(tmp_path)).restore(resumed, str(tmp_path / "last"))
    _, resumed_logs = flow.training_step(resumed, b2)
    assert resumed.step == straight.step == 3
    for k, v in logs.items():
        assert torch.equal(resumed_logs[k], v), k
    for k, v in _flat(straight).items():
        assert torch.equal(_flat(resumed)[k], v), k


# -- the trainer and the CLI ---------------------------------------------------

def test_trainer_fit_evaluate_restore(tmp_path):
    flow = _port_flow("fused_train")
    dm = Carla2D3DDataModule(batch_size=2, clip_length=3, val_set_size=4,
                             device="cpu")
    trainer = Trainer(flow, dm, TrainerConfig(
        max_epochs=2, limit_train_batches=3, log_every_n_steps=2,
        logs_dir=str(tmp_path), run_name="t", device="cpu"))
    state = trainer.fit()
    assert state.step == 6
    with open(tmp_path / "t" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [2, 3, 4, 6, 6]
    assert all(math.isfinite(r["train_loss/primary"]) for r in records)
    assert "val_loss/primary" in records[-1] and records[-1]["epoch"] == 1
    with open(tmp_path / "t" / "hparams.json") as f:
        hparams = json.load(f)
    assert hparams["data_module_name"] == "Carla2D3DDataModule"
    assert hparams["params/trajectory"] == 1

    val = trainer.evaluate("val")
    assert val["val_loss/primary"] == val["val_loss/loc_2d_3d"]
    assert val["val_loss/primary"] == records[-1]["val_loss/primary"]

    other = Trainer(flow, dm, TrainerConfig(logs_dir=str(tmp_path),
                                            run_name="u", device="cpu"))
    other.restore(str(tmp_path / "t" / "checkpoints" / "last"))
    assert other.state.step == 6
    assert other.evaluate("val") == val
    assert (tmp_path / "t" / "checkpoints" / "best.json").exists()


def test_trainer_detect_anomaly(tmp_path):
    flow = _port_flow("plain")
    dm = Carla2D3DDataModule(batch_size=2, clip_length=3, device="cpu")
    trainer = Trainer(flow, dm, TrainerConfig(
        limit_train_batches=2, log_every_n_steps=1, detect_anomaly=True,
        logs_dir=str(tmp_path), run_name="a", device="cpu"))
    trainer._init_state()
    with torch.no_grad():
        trainer.state.params["movements"]["Dense_0.bias"][0] = float("nan")
    with pytest.raises(RuntimeError, match="detect_anomaly"):
        trainer.fit()
    with open(tmp_path / "a" / "anomaly.json") as f:
        report = json.load(f)
    assert report["non_finite_params"]


def test_cli_trains_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "pedestrians_video_2_carla_torch",
         "--flow=pose_lifting", "--mode=train",
         "--data_module_name=Carla2D3D", "--movements_model_name=LinearAE",
         "--batch_size=4", "--clip_length=8", "--max_epochs=2",
         "--limit_train_batches=3", "--loss_modes", "loc_2d_3d",
         "--projection_kernel", "fused_train", "--device", "cpu",
         f"--root_dir={tmp_path}", "--run_name=smoke"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    run = tmp_path / "logs" / "pose_lifting" / "smoke"
    with open(run / "metrics.jsonl") as f:
        losses = [json.loads(line).get("train_loss/primary") for line in f]
    losses = [v for v in losses if v is not None]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    ckpts = run / "checkpoints"
    assert (ckpts / "last.pt").exists() and (ckpts / "best.json").exists()
    with open(ckpts / "best.json") as f:
        assert os.path.exists(json.load(f)["path"] + ".pt")


def test_cli_test_mode_evaluates_a_checkpoint(tmp_path):
    common = ["--movements_model_name=LinearAE", "--batch_size=2",
              "--clip_length=3", "--device=cpu", "--loss_modes", "loc_2d_3d",
              f"--root_dir={tmp_path}"]
    trained = modeling.main(["--mode=train", "--max_epochs=1",
                             "--limit_train_batches=2", "--run_name=a",
                             *common])
    ckpt = tmp_path / "logs" / "pose_lifting" / "a" / "checkpoints" / "last"
    tested = modeling.main(["--mode=test", f"--ckpt_path={ckpt}",
                            "--run_name=b", *common])
    ref = trained["trainer"].evaluate("test")
    assert tested["test_metrics"] == ref
    assert tested["trainer"].state.step == 0  # weights only


@pytest.mark.parametrize("flags", [
    "--flow=pose_estimation", "--data_module_name=AMASS",
    "--data_module_name=CarlaRecordedVideo",
    "--data_module_name=MPII",
    "--loss_modes=heatmaps"])
def test_cli_names_what_is_not_ported(flags, tmp_path):
    """The pose-estimation flow, the video data modules, the heatmaps loss,
    AMASS and MPII are ported: the flow on keypoints (the default
    Carla2D3D) and a video module under the pose-lifting flow are refused
    before any model is built, and the heatmaps loss of a pose-lifting run
    finds nothing to compute in its first step, as in the JAX CLI. AMASS
    and MPII (on synthetic files) under the default pose-lifting flow fail
    at the first step in both CLIs alike: the projection refuses their 22
    and 16 joints (F14)."""
    argv = flags.split() + ["--device=cpu", f"--root_dir={tmp_path}"]
    if flags in ("--flow=pose_estimation",
                 "--data_module_name=CarlaRecordedVideo"):
        with pytest.raises(ValueError, match="video data module"):
            modeling.main(argv)
    elif flags == "--loss_modes=heatmaps":
        with pytest.raises(RuntimeError, match="Couldn't calculate"):
            modeling.main(argv + ["--movements_model_name=Linear",
                                  "--batch_size=2", "--clip_length=3",
                                  "--val_set_size=2",
                                  "--skip_initial_metrics=true"])
    else:
        from pedestrians_video_2_carla_tpu import modeling as jmodeling
        from tests.test_torch_amass_mpii_mixed import (write_mocaps,
                                                       write_mpii)
        write_mocaps(tmp_path / "datasets", frames=40)
        write_mpii(tmp_path / "datasets")
        joints = 22 if flags.endswith("AMASS") else 16
        common = flags.split() + [
            f"--datasets_dir={tmp_path / 'datasets'}", "--batch_size=2",
            "--clip_length=3", "--max_epochs=1", "--limit_train_batches=1",
            "--renderers", "none"]
        for side, main, extra in (
                ("port", modeling.main, ["--device=cpu"]),
                ("jax", jmodeling.main, [])):
            with pytest.raises(RuntimeError, match=(
                    f"^pose_changes input has {joints} joints, skeleton "
                    f"has 26")):
                main(common + extra + [
                    f"--root_dir={tmp_path / side}",
                    f"--outputs_dir={tmp_path / side / 'outputs'}"])
