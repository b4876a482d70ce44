"""Port parity for the pose-lifting serving slice: the flax -> PyTorch weight
bridge, the synthetic Carla2D3D batch (JAX's own random draws rendered by
the port), and the whole slice (``eval_step`` losses and
``make_inference_fn`` outputs) against the JAX flow with the same weights
and batch, for plain <-> xla and fused <-> pallas, on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.data.carla import carla_2d3d as JD
from pedestrians_video_2_carla_tpu.flows.pose_lifting import \
    PoseLiftingFlow as JPoseLiftingFlow
from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
from pedestrians_video_2_carla_tpu.models.base import OptimizerSettings
from pedestrians_video_2_carla_tpu.models.movements.linear_ae import \
    LinearAE as JLinearAE

from pedestrians_video_2_carla_torch.data.carla import carla_2d3d as TD
from pedestrians_video_2_carla_torch.flows.output_types import (
    MovementsModelOutputType, TrajectoryModelOutputType)
from pedestrians_video_2_carla_torch.flows.pose_lifting import PoseLiftingFlow
from pedestrians_video_2_carla_torch.models.jax_import import (
    import_flow_params, import_linear_ae)
from pedestrians_video_2_carla_torch.models.movements.linear_ae import LinearAE
from pedestrians_video_2_carla_torch.ops import deformation as TDef
from pedestrians_video_2_carla_torch.ops import projection as TP
from pedestrians_video_2_carla_torch.serving import make_inference_fn
from .torch_threads import limit_torch_threads

limit_torch_threads()

B, L = 4, 4


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _close(port, ref, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               atol=atol, rtol=rtol, err_msg=msg)


# -- weight bridge -----------------------------------------------------------

def test_weight_bridge_linear_ae(rng):
    x = rng.standard_normal((B, L, 26, 2)).astype(np.float32)
    jmodel = JLinearAE()
    variables = jmodel.init(jax.random.PRNGKey(3), x)
    ref = np.asarray(jmodel.apply(variables, x))

    model = LinearAE(generator=torch.Generator().manual_seed(0))
    state_dict = import_linear_ae(jax.device_get(variables["params"]))
    assert set(state_dict) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert state_dict[k].shape == v.shape, k
    model.load_state_dict(state_dict)
    with torch.no_grad():
        port = model(torch.from_numpy(x)).numpy()
    _close(port, ref, atol=1e-5)


def test_seeded_init_matches_flax_init_family():
    """The port's own init: nn.Linear's default U(+-1/sqrt(fan_in)) on the
    hidden layers, and the identity head (U(+-0.1/sqrt(fan_in)), bias the
    6D identity per joint); the same generator seed gives the same
    weights."""
    def make(seed):
        return LinearAE(generator=torch.Generator().manual_seed(seed))
    a, b, c = make(7), make(7), make(8)
    for (name, p), q, r in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(p, q), name
        if name != "Dense_5.bias":
            assert not torch.equal(p, r), name
    sd = a.state_dict()
    for i in range(6):
        w = sd[f"Dense_{i}.weight"]
        bound = (0.1 if i == 5 else 1.0) / np.sqrt(w.shape[1])
        assert 0.5 * bound < float(w.abs().max()) <= bound
    assert torch.equal(sd["Dense_5.bias"], torch.tensor(
        [1., 0., 0., 0., 1., 0.]).repeat(26))

    jparams = JLinearAE().init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 1, 26, 2)))["params"]
    np.testing.assert_array_equal(np.asarray(jparams["Dense_5"]["bias"]),
                                  sd["Dense_5.bias"].numpy())


# -- synthetic data ----------------------------------------------------------

def _jax_draws(key, cfg):
    """Replay generate_batch's key splits to get JAX's own draws."""
    k_pose, k_rot0, k_rot, k_ag, _, k_label = jax.random.split(key, 6)
    Bc, Lc = cfg.batch_size, cfg.clip_length
    euler = np.zeros((Bc, Lc, 3), np.float32)
    if cfg.max_initial_world_rot_change_in_deg > 0:
        euler[:, 0, 2] = (np.asarray(jax.random.uniform(k_rot0, (Bc,))) * 2
                          - 1) * np.deg2rad(
            cfg.max_initial_world_rot_change_in_deg)
    if cfg.max_world_rot_change_in_deg != 0.0:
        euler[:, 1:, 2] = (np.asarray(jax.random.uniform(k_rot, (Bc, Lc - 1)))
                           * 2 - 1) * np.deg2rad(cfg.max_world_rot_change_in_deg)
    return TD.BatchDraws(
        pose_changes=torch.from_numpy(np.array(
            JD._random_pose_changes(k_pose, cfg))),
        world_rot_euler=torch.from_numpy(euler),
        age_gender_idx=torch.from_numpy(np.array(
            jax.random.randint(k_ag, (Bc,), 0, 4))).long(),
        crossing=torch.from_numpy(np.array(jax.random.bernoulli(
            k_label, 0.5, (Bc,)).astype(jnp.int32))))


@pytest.mark.parametrize("world_deg", [(0.0, 0.0), (10.0, 5.0)],
                         ids=["no_world", "world_yaw"])
def test_render_batch_with_jax_draws(world_deg):
    kwargs = dict(batch_size=B, clip_length=6,
                  max_world_rot_change_in_deg=world_deg[0],
                  max_initial_world_rot_change_in_deg=world_deg[1])
    key = jax.random.PRNGKey(11)
    j_inputs, j_targets, j_meta = jax.device_get(
        JD.generate_batch(key, JD.Carla2D3DConfig(**kwargs)))
    inputs, targets, meta = TD.render_batch(
        TD.Carla2D3DConfig(**kwargs), _jax_draws(key, JD.Carla2D3DConfig(**kwargs)))

    _close(inputs, j_inputs, atol=1e-5)
    np.testing.assert_array_equal(meta["age_gender_idx"], j_meta["age_gender_idx"])
    assert set(targets) == set(j_targets)
    for k, ref in j_targets.items():
        # pixels to 1e-3; the rest to float32 rounding of values up to ~1e2
        atol = 1e-3 if k == "projection_2d" else 1e-5
        _close(targets[k], ref, atol=atol, rtol=1e-5, msg=k)


def test_own_draws_invariants():
    cfg = TD.Carla2D3DConfig(batch_size=B, clip_length=8,
                             random_changes_each_frame=3, max_change_in_deg=5.0)
    draws = TD.draw_batch(cfg, torch.Generator().manual_seed(5), "cpu")
    again = TD.draw_batch(cfg, torch.Generator().manual_seed(5), "cpu")
    for a, b in zip(draws, again):
        assert torch.equal(a, b)

    m = draws.pose_changes.numpy()
    changed = np.abs(m - np.eye(3, dtype=np.float32)).max(axis=(-2, -1)) > 0
    assert (changed.sum(-1) == 3).all()       # exactly k joints per (b, l)
    # XYZ euler angles of every change lie within +-max_change_in_deg
    a0 = np.arctan2(-m[..., 1, 2], m[..., 2, 2])
    a1 = np.arcsin(np.clip(m[..., 0, 2], -1, 1))
    a2 = np.arctan2(-m[..., 0, 1], m[..., 0, 0])
    assert np.abs(np.stack([a0, a1, a2])).max() <= np.deg2rad(5.0) + 1e-6
    agi = draws.age_gender_idx.numpy()
    assert agi.min() >= 0 and agi.max() < 4
    assert not draws.world_rot_euler.any()


def test_datamodule_is_reproducible():
    def batches(**kw):
        return list(TD.Carla2D3DDataModule(
            batch_size=2, clip_length=3, test_set_size=4, val_set_size=2,
            device="cpu", **kw).test_batches())
    a, b, c = batches(), batches(), batches(seed=1)
    assert len(a) == 2
    assert torch.equal(a[0][0], b[0][0]) and torch.equal(a[1][0], b[1][0])
    assert not torch.equal(a[0][0], a[1][0])
    assert not torch.equal(a[0][0], c[0][0])
    inputs, targets, meta = a[0]
    assert inputs.shape == (2, 3, 26, 2) and inputs.dtype == torch.float32
    assert torch.isfinite(targets["projection_2d"]).all()


def test_deformation():
    x = torch.rand((2, 3, 26, 3)) + 0.5
    g = torch.Generator().manual_seed(0)
    assert torch.equal(TDef.deform(g, x), x)
    noisy = TDef.add_noise(g, x, "gaussian", 2.0)
    assert not torch.equal(noisy[..., :2], x[..., :2])
    assert torch.equal(noisy[..., 2:], x[..., 2:])
    assert torch.equal(TDef.drop_joints(g, x, [1.0] * 26),
                       torch.zeros_like(x))
    assert torch.equal(TDef.drop_joints(g, x, [0.0] * 26), x)
    with pytest.raises(ValueError):
        TDef.add_noise(g, x, "salt")


# -- routes ------------------------------------------------------------------

def test_fused_train_route_takes_the_kernels_abs_loc(monkeypatch):
    """On the identity-world pose_changes path the "fused_train" route calls
    the trainable kernel once per step, and both its outputs (projections
    and absolute pose) replace the plane path's."""
    calls = []
    real = TP.fused_projection_train

    def spy(*args):
        calls.append(args[0].shape)
        proj, abs_loc = real(*args)
        return proj, abs_loc + 1.0  # a marker the plane path cannot give
    monkeypatch.setattr(TP, "fused_projection_train", spy)

    cfg = TD.Carla2D3DConfig(batch_size=2, clip_length=3)
    batch = TD.render_batch(
        cfg, TD.draw_batch(cfg, torch.Generator().manual_seed(0), "cpu"))
    flows = {k: PoseLiftingFlow(LinearAE(), loss_modes=["loc_2d_3d"],
                                projection_kernel=k, device="cpu")
             for k in ("plain", "fused_train")}
    params = flows["plain"].init_params()
    _, plain, _ = flows["plain"].eval_step(params, batch)
    assert calls == []
    _, fused, _ = flows["fused_train"].eval_step(params, batch)
    assert len(calls) == 1
    torch.testing.assert_close(fused["absolute_pose_loc"],
                               plain["absolute_pose_loc"] + 1.0)
    torch.testing.assert_close(fused["projection_2d"], plain["projection_2d"])
    state = flows["fused_train"].init_state(params)
    flows["fused_train"].training_step(state, batch)
    assert len(calls) == 2


def test_routes_data_plane_path_flow_fused_kernel(monkeypatch):
    """Data generation passes world changes, so it never takes the fused
    kernel even when asked to; the flow with ZeroTrajectory passes None, so
    its "fused" projection does (and its "plain" one does not)."""
    calls = []
    real = TP.fused_projection

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(TP, "fused_projection", spy)

    cfg = TD.Carla2D3DConfig(batch_size=2, clip_length=3)
    draws = TD.draw_batch(cfg, torch.Generator().manual_seed(0), "cpu")
    state = TP.projection_state_for(draws.age_gender_idx)
    fused = TP.ProjectionModule(kernel="fused")
    fused(state, draws.pose_changes, torch.zeros((2, 3, 3)),
          torch.eye(3).expand(2, 3, 3, 3))
    assert calls == []

    batch = TD.render_batch(cfg, draws)
    for kernel, expected in (("plain", 0), ("fused", 1)):
        flow = PoseLiftingFlow(LinearAE(), loss_modes=["loc_2d_3d"],
                               projection_kernel=kernel, device="cpu")
        calls.clear()
        flow.eval_step(flow.init_params(), batch)
        assert len(calls) == expected, kernel


@pytest.mark.parametrize("mot,tot", [
    (MovementsModelOutputType.relative_rot, TrajectoryModelOutputType.changes),
    (MovementsModelOutputType.absolute_loc, TrajectoryModelOutputType.changes),
    (MovementsModelOutputType.absolute_loc_rot, TrajectoryModelOutputType.loc_rot),
], ids=lambda v: v.name)
def test_projection_module_other_outputs(rng, mot, tot):
    from pedestrians_video_2_carla_tpu.flows import output_types as JO
    from pedestrians_video_2_carla_tpu.ops import projection as JP

    agi = rng.integers(0, 4, size=B)
    rot = np.array(jax.device_get(JD._random_pose_changes(
        jax.random.PRNGKey(1), JD.Carla2D3DConfig(batch_size=B, clip_length=L,
                                                  max_change_in_deg=30.0))))
    loc = rng.standard_normal((B, L, 26, 3)).astype(np.float32)
    pose = {"relative_rot": rot, "absolute_loc": loc,
            "absolute_loc_rot": (loc, rot)}[mot.name]
    port_pose = tuple(map(torch.from_numpy, pose)) if isinstance(pose, tuple) \
        else torch.from_numpy(pose)
    port_proj, port_out = TP.ProjectionModule(mot, tot)(
        TP.projection_state_for(torch.from_numpy(agi)), port_pose)
    ref_proj, ref_out = JP.ProjectionModule(
        JO.MovementsModelOutputType[mot.name],
        JO.TrajectoryModelOutputType[tot.name])(
        JP.projection_state_for(agi), pose)
    _close(port_proj[..., :2], ref_proj[..., :2], atol=1e-3)
    _close(port_proj[..., 2], ref_proj[..., 2], atol=1e-5)
    for k, ref in ref_out.items():
        if ref is None:
            assert port_out[k] is None, k
        else:
            _close(port_out[k], ref, atol=1e-5, msg=k)


# -- the whole slice ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_case(kernel):
    """A JAX flow, its initialised state and a batch, and its eval_step
    (jitted: the pallas variant runs its kernel in interpret mode)."""
    batch = jax.device_get(JD.generate_batch(
        jax.random.PRNGKey(0), JD.Carla2D3DConfig(batch_size=B, clip_length=L)))
    flow = JPoseLiftingFlow(movements_model=JLinearAE(),
                            loss_modes=[JLossModes.loc_2d_3d],
                            movements_optimizer=OptimizerSettings(lr=1e-3),
                            projection_kernel=kernel)
    state = flow.init_state(jax.random.PRNGKey(1), batch)
    losses, preds, _ = jax.device_get(jax.jit(flow.eval_step)(state, batch))
    return jax.device_get(state.params), batch, losses, preds


@pytest.mark.parametrize("port_kernel,jax_kernel",
                         [("plain", "xla"), ("fused", "pallas"),
                          ("fused_train", "pallas_train")])
def test_slice_matches_jax_flow(port_kernel, jax_kernel):
    j_params, j_batch, j_losses, j_preds = _jax_case(jax_kernel)
    flow = PoseLiftingFlow(LinearAE(), loss_modes=["loc_2d_3d"],
                           projection_kernel=port_kernel, device="cpu")
    params = import_flow_params(j_params, device="cpu")
    batch = _to_torch(j_batch)

    losses, _, _ = flow.eval_step(params, batch)
    assert set(losses) == set(j_losses) == {"loc_2d", "loc_3d", "loc_2d_3d"}
    for k, ref in j_losses.items():
        _close(losses[k], ref, atol=0, rtol=1e-4, msg=k)

    # the served predictions are the eval path's predictions minus targets
    infer = make_inference_fn(flow, params)
    preds = infer(batch[0], batch[2]["age_gender_idx"])
    assert set(preds) == {k for k, v in j_preds.items() if v is not None}
    for k, v in preds.items():
        ref = j_preds[k]
        if k == "projection_2d":
            _close(v[..., :2], ref[..., :2], atol=1e-3, msg=k)
            _close(v[..., 2], ref[..., 2], atol=1e-5, msg=k)
        else:
            _close(v, ref, atol=1e-4, msg=k)
    only_2d = make_inference_fn(flow, params, output_keys=("projection_2d",))(
        batch[0], batch[2]["age_gender_idx"])
    assert list(only_2d) == ["projection_2d"]
    with pytest.raises(KeyError):
        make_inference_fn(flow, params, output_keys=("heatmaps",))(
            batch[0], batch[2]["age_gender_idx"])


def test_flow_config_errors():
    for precision in ("bf16", "16"):    # "16" is bf16, as in the JAX package
        assert PoseLiftingFlow(LinearAE(), precision=precision,
                               device="cpu").precision == "bf16"
    with pytest.raises(ValueError):
        PoseLiftingFlow(LinearAE(), precision="float16", device="cpu")
    # the heatmaps loss is ported: the flow takes it, and its step finds
    # no heatmaps to compare, as the JAX flow's does
    heatmaps = PoseLiftingFlow(
        LinearAE(generator=torch.Generator().manual_seed(0)),
        loss_modes=["heatmaps"], device="cpu")
    cfg = TD.Carla2D3DConfig(batch_size=2, clip_length=3)
    batch = TD.render_batch(
        cfg, TD.draw_batch(cfg, torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(RuntimeError, match="Couldn't calculate any loss"):
        heatmaps.training_step(heatmaps.init_state(), batch)
    # the JAX names of the kernels are not the port's
    for jax_name in ("xla", "pallas", "pallas_train"):
        with pytest.raises(ValueError):
            PoseLiftingFlow(LinearAE(), projection_kernel=jax_name,
                            device="cpu")
    assert PoseLiftingFlow(LinearAE(), projection_kernel="fused_train",
                           device="cpu").projection.kernel == "fused_train"
