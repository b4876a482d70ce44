"""Port parity for the training options, on the CPU: the loss modes
against the JAX package's (values and gradients, on seeded inputs), the
``per_joint_loc_2d`` errors, the three LR schedules against the optax
chains of the JAX ``OptimizerSettings.make`` (lrs and parameter
trajectories over scripted losses), global-norm clipping against
``optax.clip_by_global_norm`` in both flows, the pose metrics against the
JAX metrics, a LinearAE ``training_step`` with ``loc_2d_loc_rot_3d``
against the JAX flow's (``plain`` vs ``xla``, ``fused_train`` vs the
Pallas ``pallas_train`` in interpret mode, clipped), the schedules through
a checkpoint, and the CLI's flags.

Bars (the JAX kernel tests'): losses rtol 1e-4, gradients rtol 1e-4 and atol
1e-5 of each leaf's largest magnitude, metrics rtol 1e-5; PCK counts and the
lrs' schedules exactly where float32 allows (counts compared to the unit).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pedestrians_video_2_carla_tpu import losses as JL
from pedestrians_video_2_carla_tpu.data.carla import carla_2d3d as JD
from pedestrians_video_2_carla_tpu.flows.pose_lifting import \
    PoseLiftingFlow as JPoseLiftingFlow
from pedestrians_video_2_carla_tpu.metrics import fb as JFB
from pedestrians_video_2_carla_tpu.metrics import pose as JP
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.movements.linear_ae import \
    LinearAE as JLinearAE
from pedestrians_video_2_carla_tpu.skeletons.carla import \
    CARLA_SKELETON as J_SKELETON

from pedestrians_video_2_carla_torch import losses as TL
from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
    Carla2D3DDataModule
from pedestrians_video_2_carla_torch.flows.base import clip_by_global_norm
from pedestrians_video_2_carla_torch.flows.classification import \
    ClassificationFlow
from pedestrians_video_2_carla_torch.flows.pose_lifting import PoseLiftingFlow
from pedestrians_video_2_carla_torch.metrics import fb as TFB
from pedestrians_video_2_carla_torch.metrics import pose as TP
from pedestrians_video_2_carla_torch.models.base import (LRSchedule,
                                                         OptimizerSettings)
from pedestrians_video_2_carla_torch.models.jax_import import (
    flax_to_state_dict, import_flow_params)
from pedestrians_video_2_carla_torch.models.movements.linear_ae import LinearAE
from pedestrians_video_2_carla_torch.skeletons.carla import CARLA_SKELETON
from pedestrians_video_2_carla_torch.training.trainer import (Trainer,
                                                              TrainerConfig)

from .ops.np_reference import random_rotation_matrices
from .torch_threads import limit_torch_threads

limit_torch_threads()

B, L, J = 2, 4, 26
LR = 1e-3


def _scaled_close(port, ref, msg="", atol=1e-5):
    """Each leaf over its largest magnitude: rtol 1e-4, atol 1e-5."""
    port, ref = np.asarray(port), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-8)
    np.testing.assert_allclose(port / scale, ref / scale, rtol=1e-4,
                               atol=atol, err_msg=msg)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


# -- the loss modes ------------------------------------------------------------

def _loss_inputs(seed=0):
    """Seeded predictions and targets of every key a loss reads; a few
    ground-truth joints missing (exact zeros, never the hips)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    gt2d = rng.normal(size=(B, L, J, 2)).astype(f32)
    gt2d[0, 1, 5] = 0.0
    gt2d[1, :, 7] = 0.0
    gt2d[1, 2, 20] = 0.0
    sliced = {
        "projection_2d_transformed": rng.normal(size=(B, L, J, 2)).astype(f32),
        "absolute_pose_loc": rng.normal(size=(B, L, J, 3)).astype(f32),
        "absolute_pose_rot": random_rotation_matrices(
            rng, (B, L, J)).astype(f32),
        "pose_inputs": random_rotation_matrices(rng, (B, L, J)).astype(f32),
    }
    targets = {
        "projection_2d_transformed": gt2d,
        "absolute_pose_loc": rng.normal(size=(B, L, J, 3)).astype(f32),
        "absolute_pose_rot": random_rotation_matrices(
            rng, (B, L, J)).astype(f32),
        "pose_changes": random_rotation_matrices(rng, (B, L, J)).astype(f32),
    }
    return sliced, targets


LOSS_WEIGHTS = {"loc_2d": 0.5, "loc_3d": 2.0, "rot_3d": 3.0}
PER_JOINT_WEIGHTS = tuple(np.random.default_rng(3).uniform(
    0.1, 2.0, size=J).round(3))

#: (mode, loss_params, mask_missing_joints)
LOSS_CASES = [
    ("common_loc_2d", None, True), ("rot_3d", None, True),
    ("cum_pose_changes", None, True), ("pose_changes", None, True),
    ("loc_2d_loc_rot_3d", None, True),
    ("weighted_loc_2d_loc_rot_3d", None, True), ("loc_rot_3d", None, True),
    ("per_joint_loc_2d", PER_JOINT_WEIGHTS, True),
    ("per_joint_loc_2d", None, True),
    ("per_joint_loc_2d", PER_JOINT_WEIGHTS, False)]
LOSS_IDS = ["common_loc_2d", "rot_3d", "cum_pose_changes", "pose_changes",
            "loc_2d_loc_rot_3d", "weighted_loc_2d_loc_rot_3d", "loc_rot_3d",
            "per_joint_loc_2d", "per_joint_loc_2d-unweighted",
            "per_joint_loc_2d-unmasked"]


def _jax_losses(mode, loss_params, mask, sliced, targets):
    """-> (the JAX loss dict, the primary's gradients w.r.t. sliced)."""
    requested = [JL.LossModes[mode]]
    chain = JL.resolve_loss_modes(requested)

    def primary(s):
        ctx = JL.LossContext(
            input_nodes=J_SKELETON, output_nodes=J_SKELETON, sliced=s,
            targets=targets, loss_weights=LOSS_WEIGHTS,
            loss_params=loss_params, mask_missing_joints=mask)
        losses = JL.calculate_losses(chain, requested, ctx)
        return JL.primary_loss(losses, requested)[1], losses
    (_, losses), grads = jax.value_and_grad(primary, has_aux=True)(
        {k: jnp.asarray(v) for k, v in sliced.items()})
    return jax.device_get(losses), jax.device_get(grads)


def _port_losses(mode, loss_params, mask, sliced, targets):
    requested = [TL.LossModes[mode]]
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in sliced.items()}
    ctx = TL.LossContext(
        input_nodes=CARLA_SKELETON, output_nodes=CARLA_SKELETON,
        sliced=leaves, targets=_to_torch(targets),
        loss_weights=LOSS_WEIGHTS, loss_params=loss_params,
        mask_missing_joints=mask)
    losses = TL.calculate_losses(TL.resolve_loss_modes(requested), requested,
                                 ctx)
    TL.primary_loss(losses, requested)[1].backward()
    return losses, leaves


@pytest.mark.parametrize("mode,loss_params,mask", LOSS_CASES, ids=LOSS_IDS)
def test_loss_mode_matches_jax(mode, loss_params, mask):
    sliced, targets = _loss_inputs()
    j_losses, j_grads = _jax_losses(mode, loss_params, mask, sliced, targets)
    losses, leaves = _port_losses(mode, loss_params, mask, sliced, targets)
    # common_loc_2d is loc_2d's alias in both packages
    assert set(losses) == set(j_losses) and losses
    for k, ref in j_losses.items():
        np.testing.assert_allclose(float(losses[k].detach()), float(ref),
                                   rtol=1e-4, err_msg=k)
    for k, leaf in leaves.items():
        g = np.zeros_like(sliced[k]) if leaf.grad is None \
            else leaf.grad.numpy()
        if not np.abs(j_grads[k]).max():
            assert not np.abs(g).max(), k
            continue
        _scaled_close(g, j_grads[k], msg=k)


def test_rotation_losses_need_rotation_outputs():
    """cum_pose_changes and pose_changes are unavailable for a 2D output
    (not a (3, 3) rotation), as in the JAX package."""
    sliced, targets = _loss_inputs()
    sliced = dict(sliced, pose_inputs=sliced["projection_2d_transformed"])
    for mode in ("cum_pose_changes", "pose_changes"):
        requested = [TL.LossModes[mode]]
        ctx = TL.LossContext(CARLA_SKELETON, CARLA_SKELETON,
                             _to_torch(sliced), _to_torch(targets))
        assert TL.calculate_losses(requested, requested, ctx) == {}
        with pytest.raises(RuntimeError, match="Couldn't"):
            TL.primary_loss({}, requested)


def test_per_joint_loc_2d_errors_match_jax(monkeypatch):
    """The two ValueErrors: too few weights for the common input indices
    (reachable only with an index array, so both packages' common indices
    are forced to every other joint), and a count that is not the common
    joints'. Their value with the index arrays matches too."""
    sliced, targets = _loss_inputs()
    idx = np.arange(0, J, 2)
    for mod in (JL, TL):
        monkeypatch.setattr(mod, "get_common_indices", lambda i, o: (idx, idx))
    for params, match in ((PER_JOINT_WEIGHTS[:10], "reach index 24"),
                          (None, None)):
        if match is None:
            j_losses, _ = _jax_losses("per_joint_loc_2d", PER_JOINT_WEIGHTS,
                                      True, sliced, targets)
            losses, _ = _port_losses("per_joint_loc_2d", PER_JOINT_WEIGHTS,
                                     True, sliced, targets)
            np.testing.assert_allclose(
                float(losses["per_joint_loc_2d"].detach()),
                float(j_losses["per_joint_loc_2d"]), rtol=1e-4)
            continue
        with pytest.raises(ValueError, match=match) as j_err:
            _jax_losses("per_joint_loc_2d", params, True, sliced, targets)
        with pytest.raises(ValueError, match=match) as t_err:
            _port_losses("per_joint_loc_2d", params, True, sliced, targets)
        assert str(t_err.value) == str(j_err.value)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="30 weights for 26") as t_err:
        _port_losses("per_joint_loc_2d", (1.0,) * 30, True, sliced, targets)
    with pytest.raises(ValueError) as j_err:
        _jax_losses("per_joint_loc_2d", (1.0,) * 30, True, sliced, targets)
    assert str(t_err.value) == str(j_err.value)


# -- the LR schedules ----------------------------------------------------------

def _schedule_run(settings_kwargs, steps_per_epoch, losses, seed=1):
    """The same gradient sequence and losses through the JAX
    ``OptimizerSettings.make`` chain and the port's AdamW + LRSchedule, on
    one (5,) parameter: -> (port params, port lrs, JAX params, JAX lrs)
    per step. The JAX lr is the schedule's value at the update's count, or
    for ReduceLROnPlateau lr times the scale its state holds after the
    update."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    grads = rng.normal(size=(len(losses), 5)).astype(np.float32)

    j_settings = JOptimizerSettings(**settings_kwargs)
    tx = j_settings.make(steps_per_epoch)
    j_p = {"w": jnp.asarray(p0)}
    j_state = tx.init(j_p)
    s = j_settings
    step_lr = optax.exponential_decay(
        1.0, s.scheduler_step_size * steps_per_epoch, s.scheduler_gamma,
        staircase=True)
    period = max(1, s.scheduler_step_size) * steps_per_epoch
    cosine = optax.sgdr_schedule([
        {"init_value": s.learning_rate, "peak_value": s.learning_rate,
         "decay_steps": period, "warmup_steps": 0,
         "end_value": s.scheduler_min_lr}] * 64)

    settings = OptimizerSettings(**settings_kwargs)
    p = torch.from_numpy(p0.copy()).requires_grad_(True)
    opt = settings.make([p])
    schedule = settings.schedule(steps_per_epoch)
    out = {"port": [], "port_lr": [], "jax": [], "jax_lr": []}
    for i, (g, loss) in enumerate(zip(grads, losses)):
        value = jnp.float32(loss)
        upd, j_state = tx.update({"w": jnp.asarray(g)}, j_state, j_p,
                                 value=value)
        j_p = optax.apply_updates(j_p, upd)
        if s.scheduler_type == "StepLR":
            j_lr = s.learning_rate * float(step_lr(i))
        elif s.scheduler_type == "CosineAnnealingWarmRestarts":
            j_lr = float(cosine(i))
        else:
            j_lr = s.learning_rate * float(j_state[-1].scale)
        out["jax"].append(np.asarray(j_p["w"]))
        out["jax_lr"].append(j_lr)

        p.grad = torch.from_numpy(g)
        lr = schedule.lr(i, torch.tensor(loss, dtype=torch.float32))
        opt.param_groups[0]["lr"] = lr
        opt.step()
        out["port"].append(p.detach().numpy().copy())
        out["port_lr"].append(lr)
    return out


#: ReduceLROnPlateau over 3-step epochs whose mean losses go 1, 1, 1 (a
#: plateau of 2 = patience: scale 0.5, then a cooldown epoch), 1, 1, 1
#: (0.25, cooldown), then 0.5 (an improvement), 0.5, 0.5 (0.125, floored at
#: min_lr / lr = 0.2), 0.5, 0.5
PLATEAU_EPOCH_MEANS = (1.0,) * 7 + (0.5,) * 6
PLATEAU_KWARGS = dict(lr=0.1, enable_lr_scheduler=True,
                      scheduler_type="ReduceLROnPlateau",
                      scheduler_gamma=0.5, scheduler_patience=2,
                      scheduler_cooldown=1, scheduler_min_lr=0.02,
                      weight_decay=0.1)


def _plateau_losses():
    return [m + d for m in PLATEAU_EPOCH_MEANS for d in (-0.1, 0.0, 0.1)]


@pytest.mark.parametrize("kind", ["ReduceLROnPlateau", "StepLR",
                                  "CosineAnnealingWarmRestarts"])
def test_lr_schedule_matches_optax(kind):
    """The lrs each update takes and the parameters they give, with a
    large weight decay: the scale multiplies the decay as well. StepLR: 2
    epochs of 3 steps a transition; the cosine: periods of 2 steps, run one
    period and a step past the 64th (optax holds min_lr there, where a
    plain modulus would restart)."""
    if kind == "ReduceLROnPlateau":
        kwargs, spe, losses = PLATEAU_KWARGS, 3, _plateau_losses()
    elif kind == "StepLR":
        kwargs = dict(lr=0.1, enable_lr_scheduler=True, scheduler_type=kind,
                      scheduler_gamma=0.5, scheduler_step_size=2,
                      weight_decay=0.1)
        spe, losses = 3, [1.0] * 20
    else:
        kwargs = dict(lr=0.1, enable_lr_scheduler=True, scheduler_type=kind,
                      scheduler_step_size=1, scheduler_min_lr=0.01,
                      weight_decay=0.1)
        spe, losses = 2, [1.0] * 131
    out = _schedule_run(kwargs, spe, losses)
    np.testing.assert_allclose(out["port_lr"], out["jax_lr"], rtol=1e-6)
    np.testing.assert_allclose(np.stack(out["port"]), np.stack(out["jax"]),
                               rtol=2e-5, atol=1e-6)
    lrs = out["port_lr"]
    if kind == "ReduceLROnPlateau":
        # epoch-closing steps (the third of each) take the new scale
        scales = [round(lr / 0.1, 6) for lr in lrs[2::3]]
        assert scales == [1.0, 1.0, 0.5, 0.5, 0.5, 0.25, 0.25, 0.25, 0.25,
                          0.2, 0.2, 0.2, 0.2]
        assert lrs[7] == 0.1 and lrs[8] == pytest.approx(0.05)
    elif kind == "StepLR":
        assert lrs[5] == 0.1 and lrs[6] == pytest.approx(0.05)
    else:
        assert lrs[126] == pytest.approx(0.1)
        assert lrs[127] == pytest.approx(0.055)
        assert lrs[128] == lrs[129] == lrs[130] == pytest.approx(0.01)


def test_lr_schedule_rejects_what_optax_rejects():
    with pytest.raises(ValueError, match="Unknown"):
        LRSchedule(OptimizerSettings(enable_lr_scheduler=True,
                                     scheduler_type="Cyclic"))
    with pytest.raises(ValueError, match="Factor"):
        LRSchedule(OptimizerSettings(enable_lr_scheduler=True,
                                     scheduler_gamma=1.0))
    assert OptimizerSettings().schedule() is None


# -- clipping ------------------------------------------------------------------

def _flow_grads(flow, batch, clip):
    flow.gradient_clip_val = clip
    state = flow.init_state()
    flow.training_step(state, batch)
    return {f"{n}.{k}": v.grad for n, tree in state.params.items()
            for k, v in tree.items()}


@pytest.mark.parametrize("flow_name", ["pose_lifting", "classification"])
def test_clipping_matches_optax(flow_name):
    """A training step's gradients with clipping, against
    ``optax.clip_by_global_norm`` of the same step's unclipped gradients
    (every model's gradients in one norm), at a bound below the norm and
    one above it."""
    batch = next(Carla2D3DDataModule(batch_size=2, clip_length=3,
                                     device="cpu").train_batches())
    if flow_name == "pose_lifting":
        def make():
            return PoseLiftingFlow(
                LinearAE(generator=torch.Generator().manual_seed(0)),
                loss_modes=["loc_2d_loc_rot_3d"], device="cpu")
    else:
        def make():
            return ClassificationFlow(device="cpu")
    raw = _flow_grads(make(), batch, 0.0)
    tree = {k: jnp.asarray(v.numpy()) for k, v in raw.items()
            if v is not None}
    norm = float(optax.global_norm(tree))
    for clip in (0.5 * norm, 2.0 * norm):
        ref, _ = optax.clip_by_global_norm(clip).update(tree, None)
        got = _flow_grads(make(), batch, clip)
        for k, r in ref.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(r),
                                       rtol=1e-5, atol=1e-8, err_msg=k)
    # the rule itself: kept below the bound, g / norm * bound above it
    p = torch.ones(3, requires_grad=True)
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    assert float(clip_by_global_norm([p], 10.0)) == 5.0
    assert p.grad.tolist() == [3.0, 4.0, 0.0]
    clip_by_global_norm([p], 1.0)
    np.testing.assert_allclose(p.grad.numpy(), [0.6, 0.8, 0.0], rtol=1e-6)


# -- the pose metrics ----------------------------------------------------------

def _metric_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    gt2d = rng.uniform(0.0, 1.0, size=(B, L, J, 2)).astype(f32)
    gt2d[0, 1, 5] = 0.0
    gt2d[1, :, 7] = 0.0
    pred2d = (gt2d + rng.normal(scale=0.05, size=gt2d.shape)).astype(f32)
    pred2d[1, 2, 3] = 0.0
    gt3d = rng.normal(size=(B, L, J, 3)).astype(f32)
    preds = {"projection_2d": pred2d, "projection_2d_transformed": pred2d,
             "absolute_pose_loc": (gt3d + rng.normal(
                 scale=0.1, size=gt3d.shape)).astype(f32),
             "world_loc": rng.normal(scale=0.1, size=(B, L, 3)).astype(f32)}
    targets = {"projection_2d": gt2d, "projection_2d_transformed": gt2d,
               "absolute_pose_loc": gt3d,
               "world_loc_changes": rng.normal(
                   scale=0.05, size=(B, L, 3)).astype(f32)}
    return preds, targets


def _metric_pairs():
    """(name, JAX metric, port metric)."""
    return [
        ("MPJPE", JP.MPJPE(J_SKELETON), TP.MPJPE(CARLA_SKELETON)),
        ("MRPE", JP.MRPE(J_SKELETON, J_SKELETON),
         TP.MRPE(CARLA_SKELETON, CARLA_SKELETON)),
        ("PCKhn@01", JP.PCK(J_SKELETON, J_SKELETON, threshold=0.1,
                            normalization="hn"),
         TP.PCK(CARLA_SKELETON, CARLA_SKELETON, threshold=0.1,
                normalization="hn")),
        ("PCK@005", JP.PCK(J_SKELETON, J_SKELETON, threshold=0.05,
                           normalization="bbox"),
         TP.PCK(CARLA_SKELETON, CARLA_SKELETON, threshold=0.05,
                normalization="bbox")),
        ("MJR", JP.MissingJointsRatio(J_SKELETON, J_SKELETON),
         TP.MissingJointsRatio(CARLA_SKELETON, CARLA_SKELETON)),
        ("MJR/per_joint", JP.MissingJointsRatio(J_SKELETON, J_SKELETON,
                                                report_per_joint=True),
         TP.MissingJointsRatio(CARLA_SKELETON, CARLA_SKELETON,
                               report_per_joint=True)),
        ("MSE", JP.MultiinputMSE(input_nodes=J_SKELETON,
                                 output_nodes=J_SKELETON),
         TP.MultiinputMSE(input_nodes=CARLA_SKELETON,
                          output_nodes=CARLA_SKELETON)),
        ("FB_MPJPE", JFB.FB_MPJPE(), TFB.FB_MPJPE()),
        ("FB_WeightedMPJPE", JFB.FB_WeightedMPJPE(),
         TFB.FB_WeightedMPJPE()),
        ("FB_N_MPJPE", JFB.FB_N_MPJPE(), TFB.FB_N_MPJPE()),
        ("FB_PA_MPJPE", JFB.FB_PA_MPJPE(), TFB.FB_PA_MPJPE()),
        ("FB_MPJVE", JFB.FB_MPJVE(), TFB.FB_MPJVE()),
    ]


METRIC_NAMES = [name for name, _, _ in _metric_pairs()]


@pytest.mark.parametrize("name", METRIC_NAMES)
def test_pose_metric_matches_jax(name):
    """Two updates (two seeded batches), then compute."""
    j_metric, t_metric = next((j, t) for n, j, t in _metric_pairs()
                              if n == name)
    j_state, t_state = j_metric.init_state(), t_metric.init_state("cpu")
    for seed in (0, 1):
        preds, targets = _metric_inputs(seed)
        j_state = j_metric.update(
            j_state, {k: jnp.asarray(v) for k, v in preds.items()},
            {k: jnp.asarray(v) for k, v in targets.items()})
        t_state = t_metric.update(t_state, _to_torch(preds),
                                  _to_torch(targets))
    for k, v in j_state.items():
        got = t_state[k].numpy()
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            assert got.tolist() == np.asarray(v).tolist(), k
        else:
            np.testing.assert_allclose(got, np.asarray(v), rtol=1e-5,
                                       err_msg=k)
    ref, got = j_metric.compute(j_state), t_metric.compute(t_state)
    if isinstance(ref, dict):
        assert set(ref) == set(got)
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    assert np.isfinite(float(got if not isinstance(got, dict)
                             else got["overall"]))


@pytest.mark.parametrize("normalization,threshold", [("hn", 0.1),
                                                     ("bbox", 0.05)])
def test_pck_counts_are_exact(normalization, threshold):
    """PCK counts the same joints as the JAX metric. A distance within
    float32 rounding of the threshold could land on either side in the two
    packages: such elements are counted and named in the failure message,
    not skipped."""
    preds, targets = _metric_inputs(0)
    metric = TP.PCK(CARLA_SKELETON, CARLA_SKELETON, threshold=threshold,
                    normalization=normalization)
    dist, mask = metric.distances(_to_torch(preds), _to_torch(targets))
    near = int(((dist - threshold).abs() <= 1e-6 * threshold)[mask].sum())
    j_metric = JP.PCK(J_SKELETON, J_SKELETON, threshold=threshold,
                      normalization=normalization)
    j_state = j_metric.update(
        j_metric.init_state(),
        {k: jnp.asarray(v) for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in targets.items()})
    t_state = metric.update(metric.init_state("cpu"), _to_torch(preds),
                            _to_torch(targets))
    assert int(t_state["correct"]) == int(j_state["correct"]), \
        f"{near} distances within float32 rounding of the threshold"
    assert int(t_state["total"]) == int(j_state["total"])
    assert 0 < int(t_state["correct"]) < int(t_state["total"])


def test_pose_lifting_flow_logs_the_pose_metrics(tmp_path):
    """The trainer accumulates the pose-lifting flow's metrics over a val
    pass, beside the losses; MPJPE there equals the metric on the eval
    step's outputs."""
    dm = Carla2D3DDataModule(batch_size=2, clip_length=3, val_set_size=4,
                             device="cpu")
    flow = PoseLiftingFlow(LinearAE(generator=torch.Generator().manual_seed(0)),
                           loss_modes=["loc_2d_3d"], device="cpu")
    assert sorted(flow.metrics.metrics) == sorted(JPoseLiftingFlow(
        movements_model=JLinearAE()).metrics.metrics)
    trainer = Trainer(flow, dm, TrainerConfig(logs_dir=str(tmp_path),
                                              device="cpu"))
    results = trainer.evaluate("val")
    for name in ("MPJPE", "MRPE", "FB_MPJPE", "FB_WeightedMPJPE",
                 "FB_PA_MPJPE", "FB_N_MPJPE", "FB_MPJVE"):
        assert np.isfinite(results[f"val_{name}"]), name
    metric, state = TP.MPJPE(), TP.MPJPE().init_state("cpu")
    for batch in dm.val_batches():
        _, preds, targets = flow.eval_step(trainer.state.params, batch)
        state = metric.update(state, preds, targets)
    np.testing.assert_allclose(results["val_MPJPE"],
                               float(metric.compute(state)), rtol=1e-6)
    # the pose-lifting baseline has no 3D pose: no initial metric moved
    assert trainer.initial_metrics() == {}


# -- a LinearAE training step against the JAX flow -------------------------------

CLIP_VAL = 0.05


@functools.lru_cache(maxsize=None)
def _jax_step_case(kernel):
    """A JAX flow's initial params, a batch and one clipped training step
    with ``loc_2d_loc_rot_3d``: the losses, the clipped gradients and the
    new params."""
    batch = jax.device_get(JD.generate_batch(
        jax.random.PRNGKey(5), JD.Carla2D3DConfig(batch_size=B,
                                                  clip_length=L)))
    flow = JPoseLiftingFlow(movements_model=JLinearAE(),
                            loss_modes=[JL.LossModes.loc_2d_loc_rot_3d],
                            movements_optimizer=JOptimizerSettings(lr=LR),
                            gradient_clip_val=CLIP_VAL,
                            projection_kernel=kernel)
    state = flow.init_state(jax.random.PRNGKey(1), batch)

    def loss_fn(params):
        sliced, _ = flow._inner_step(params, state.mutables, batch,
                                     training=True, rngs=None)
        losses = flow._compute_losses(sliced, sliced["targets"])
        return JL.primary_loss(losses, flow.requested_loss_modes)[1], losses
    (primary, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params)
    clipped, _ = optax.clip_by_global_norm(CLIP_VAL).update(grads, None)
    updates, _ = flow._tx.update(grads, state.opt_state, state.params,
                                 value=primary)
    new_params = optax.apply_updates(state.params, updates)
    return jax.device_get((state.params, batch, losses, clipped, new_params,
                           optax.global_norm(grads)))


#: the scaled gradient atol of each pair, as in test_torch_training.py: the
#: plain route accumulates the rotations in a loop, JAX's xla route in an
#: associative scan
GRAD_ATOL = {"fused_train": 1e-5, "plain": 5e-5}


@pytest.mark.parametrize("port_kernel,jax_kernel",
                         [("fused_train", "pallas_train"), ("plain", "xla")])
def test_linear_ae_step_with_rot_3d_matches_jax(port_kernel, jax_kernel):
    """rot_3d reads absolute_pose_rot from the plane path on both routes,
    loc_3d absolute_pose_loc from the kernel on fused_train; the clipped
    gradients and the AdamW update."""
    j_params, j_batch, j_losses, j_clipped, j_new, j_norm = \
        _jax_step_case(jax_kernel)
    assert float(j_norm) > CLIP_VAL   # the bound clips
    flow = PoseLiftingFlow(LinearAE(), loss_modes=["loc_2d_loc_rot_3d"],
                           movements_optimizer=OptimizerSettings(lr=LR),
                           gradient_clip_val=CLIP_VAL,
                           projection_kernel=port_kernel, device="cpu")
    state = flow.init_state(import_flow_params(j_params, device="cpu"))
    _, logs = flow.training_step(state, _to_torch(j_batch))
    assert {k.split("/")[1] for k in logs} - {"primary"} == set(j_losses) \
        == {"loc_2d", "loc_3d", "rot_3d", "loc_2d_loc_rot_3d"}
    for k, ref in j_losses.items():
        np.testing.assert_allclose(float(logs[f"train_loss/{k}"]), ref,
                                   rtol=1e-4, err_msg=k)
    for name, tree in state.params.items():
        ref_grads = flax_to_state_dict(j_clipped[name])
        ref_new = flax_to_state_dict(j_new[name])
        for k, p in tree.items():
            g_ref = ref_grads[k].numpy()
            g = np.zeros_like(g_ref) if p.grad is None else p.grad.numpy()
            _scaled_close(g, g_ref, msg=f"grad {name}.{k}",
                          atol=GRAD_ATOL[port_kernel])
            diff = np.abs(p.detach().numpy() - ref_new[k].numpy())
            big = np.abs(g_ref) > 1e-4 * np.abs(g_ref).max()
            assert diff[big].max(initial=0.0) <= 1e-5, f"{name}.{k}"
            assert diff[~big].max(initial=0.0) <= 2 * LR + 1e-6, \
                f"{name}.{k}"


# -- the schedules in the flow, the trainer and checkpoints -----------------------

def test_schedule_state_restores_exactly(tmp_path):
    """A flow on ReduceLROnPlateau (one-step epochs, patience 1): the
    lrs ``current_lrs`` reports move as the rule says, and a checkpoint
    taken mid-run restores the plateau state, so that the restored run
    takes the same lrs and params as the original."""
    settings = OptimizerSettings(
        lr=1e-3, enable_lr_scheduler=True, scheduler_patience=1,
        scheduler_cooldown=0, scheduler_gamma=0.5)

    def make():
        return PoseLiftingFlow(
            LinearAE(generator=torch.Generator().manual_seed(0)),
            loss_modes=["loc_2d"], movements_optimizer=settings,
            device="cpu")
    dm = Carla2D3DDataModule(batch_size=2, clip_length=3, device="cpu")
    stream = dm.train_batches(0)
    batches = [next(stream) for _ in range(6)]
    flow = make()
    state = flow.init_state()
    assert flow.current_lrs(state)["lr-movements"] == 1e-3
    from pedestrians_video_2_carla_torch.training.checkpoint import \
        CheckpointManager
    ckpt = CheckpointManager(str(tmp_path))
    lrs = []
    for i, batch in enumerate(batches):
        flow.training_step(state, batch)
        lrs.append(flow.current_lrs(state)["lr-movements"])
        if i == 2:
            ckpt.save(state, {}, step=3)
    other = make()
    restored = other.init_state()
    ckpt.restore(restored, str(tmp_path / "last"))
    assert restored.schedules["movements"].state_dict()["scale"] \
        == pytest.approx(lrs[2] / 1e-3)
    for batch in batches[3:]:
        other.training_step(restored, batch)
    assert other.current_lrs(restored) == flow.current_lrs(state)
    for k, v in state.params["movements"].items():
        assert torch.equal(v, restored.params["movements"][k]), k
    assert min(lrs) < 1e-3        # the train losses plateaued at least once


def test_trainer_sets_steps_per_epoch(tmp_path):
    dm = Carla2D3DDataModule(batch_size=2, clip_length=3, val_set_size=2,
                             device="cpu")
    flow = PoseLiftingFlow(LinearAE(), loss_modes=["loc_2d"], device="cpu",
                           movements_optimizer=OptimizerSettings(
                               enable_lr_scheduler=True,
                               scheduler_type="StepLR",
                               scheduler_gamma=0.5))
    trainer = Trainer(flow, dm, TrainerConfig(
        max_epochs=2, limit_train_batches=3, logs_dir=str(tmp_path),
        log_every_n_steps=1, device="cpu"))
    state = trainer.fit()
    assert flow.steps_per_epoch == 3
    assert state.schedules["movements"].steps_per_epoch == 3
    assert flow.current_lrs(state)["lr-movements"] == pytest.approx(0.025)


@pytest.mark.parametrize("flags", [
    ["--movements_enable_lr_scheduler",
     "--movements_scheduler_type=ReduceLROnPlateau",
     "--loss_modes", "weighted_loc_2d_loc_rot_3d",
     "--loss_weights", "loc_2d=1.0", "rot_3d=3.0"],
    ["--movements_enable_lr_scheduler", "--movements_scheduler_type=StepLR",
     "--gradient_clip_val=0.5", "--loss_modes", "cum_pose_changes",
     "--projection_kernel=fused_train"],
    ["--movements_enable_lr_scheduler",
     "--movements_scheduler_type=CosineAnnealingWarmRestarts",
     "--loss_modes", "per_joint_loc_2d", "--loss_params_0=2.0",
     "--loss_params_25=1.0"]],
    ids=["plateau_weighted", "steplr_clipped", "cosine_per_joint"])
def test_cli_training_options(flags, tmp_path):
    out = modeling.main(["--movements_model_name=LinearAE",
                         "--batch_size=2", "--clip_length=3",
                         "--max_epochs=2", "--limit_train_batches=2",
                         "--val_set_size=2", "--log_every_n_steps=1",
                         "--device=cpu", f"--root_dir={tmp_path}",
                         "--run_name=opts", *flags])
    flow = out["flow"]
    assert flow.movements_optimizer.enable_lr_scheduler
    assert flow.movements_optimizer.learning_rate == 5e-2
    assert np.isfinite(out["val_metrics"]["val_loss/primary"])
    assert np.isfinite(out["val_metrics"]["val_MPJPE"])
    if "--loss_weights" in flags:
        assert flow.loss_weights == {"loc_2d": 1.0, "rot_3d": 3.0}
    if "--gradient_clip_val=0.5" in flags:
        assert flow.gradient_clip_val == 0.5
        assert out["trainer"].state.schedules["movements"].lr(2) \
            == pytest.approx(0.05 * 0.98)
    if "--loss_params_0=2.0" in flags:
        assert flow.loss_params == [2.0] + [0.0] * 24 + [1.0]
