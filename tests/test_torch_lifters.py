"""Port parity for BASELINE config 4's slice and the rest of the movements
zoo, on the CPU: the ten new models (``VideoPose3D``, ``Baseline3DPose``,
``Baseline3DPoseRot``, ``LinearAE2D``, ``LinearAEResidual``,
``LinearAEResidualLeaky``, ``SimpleTransformer``, ``SpatialGnn``,
``GNNLinearAutoencoder``, ``VariationalGcn``) against their flax
counterparts through ``models/jax_import.py``, in evaluation with
randomised ``batch_stats`` and in training with the new ``batch_stats``
(flax ``mutable=["batch_stats"]``); the port's BatchNorm against flax's; one
``training_step`` of ``PoseLiftingFlow`` (VideoPose3D, Baseline3DPose,
LinearAEResidual) and of ``AutoencoderFlow`` (SimpleTransformer) against
the JAX flow's: losses, gradients, running statistics, parameter counts;
the registry; ``video_pose_3d_flops`` against a count by hand.

Bars: outputs within 1e-5 of max |out| (flax, fp32); running statistics
rtol 1e-5; losses rtol 1e-4; each gradient within 1e-4 of its leaf's
largest magnitude (atol 1e-5 scaled). Dropout masks (and VariationalGcn's
training noise) come from the flow's ``torch.Generator``, not the JAX PRNG
stream (``ROADMAP.md`` F3): the training cases run with dropout off, the
flax modules' ``nn.Dropout`` patched to the identity where the rate is
fixed in the model (LinearAEResidual's 0.5) and the JAX transformer's
encoder layers built with their dropout at 0 (SimpleTransformer's 0.1).

Inputs are seeded numpy; the flow steps take Carla2D3D's targets. Its own
inputs are not used there: after the hips_neck normalisation some input
features are the same in every frame, and BatchNorm's fast variance
(mean(x^2) - mean(x)^2, flax's rule) then loses digits in float32. The JAX
model and the port both land over 1e-4 of max |out| from a float64
evaluation of VideoPose3D's training forward on such a batch (F9 in
``ROADMAP.md``; pinned by the last test here), which no bar of 1e-4
between them can hold.
"""
import functools

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.data.carla import carla_2d3d as JD
from pedestrians_video_2_carla_tpu.flows.autoencoder import \
    AutoencoderFlow as JAutoencoderFlow
from pedestrians_video_2_carla_tpu.flows.pose_lifting import \
    PoseLiftingFlow as JPoseLiftingFlow
from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
from pedestrians_video_2_carla_tpu.losses import primary_loss as j_primary
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.movements import \
    MOVEMENTS_MODELS as J_MODELS
from pedestrians_video_2_carla_tpu.models.movements import transformers as JT

from pedestrians_video_2_carla_torch.flows.autoencoder import AutoencoderFlow
from pedestrians_video_2_carla_torch.flows.pose_lifting import PoseLiftingFlow
from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
from pedestrians_video_2_carla_torch.models.jax_import import (
    batch_stats_to_state_dict, flax_to_state_dict, import_flow_params)
from pedestrians_video_2_carla_torch.models.movements import MOVEMENTS_MODELS
from pedestrians_video_2_carla_torch.models.movements.common import BatchNorm
from pedestrians_video_2_carla_torch.ops.flops import video_pose_3d_flops
from .torch_threads import limit_torch_threads

limit_torch_threads()

B, L = 3, 9
LR = 1e-3
OUT_BAR, STATS_RTOL, GRAD_ATOL = 1e-5, 1e-5, 1e-5

#: case -> (model, small sizes, clip length)
CASES = {
    "VideoPose3D": ("VideoPose3D",
                    {"filter_widths": (3, 3), "channels": 64}, L),
    "VideoPose3D_L5": ("VideoPose3D",
                       {"filter_widths": (3, 3), "channels": 64}, 5),
    "Baseline3DPose": ("Baseline3DPose",
                       {"linear_size": 64, "num_stage": 2}, L),
    "Baseline3DPoseRot": ("Baseline3DPoseRot",
                          {"linear_size": 64, "num_stage": 1}, L),
    "LinearAE2D": ("LinearAE2D", {}, L),
    "LinearAEResidual": ("LinearAEResidual", {"linear_size": 64}, L),
    "LinearAEResidualLeaky": ("LinearAEResidualLeaky",
                              {"linear_size": 64}, L),
    "SimpleTransformer": ("SimpleTransformer", {"num_layers": 2}, L),
    "SpatialGnn": ("SpatialGnn", {"hidden_size": 16}, L),
    "GNNLinearAutoencoder": ("GNNLinearAutoencoder", {}, L),
    "VariationalGcn": ("VariationalGcn", {}, L),
}
#: the models whose dropout rate is a constructor argument
P_DROPOUT = {"VideoPose3D", "Baseline3DPose", "Baseline3DPoseRot"}


def _no_dropout(case):
    name, sizes, _ = CASES[case]
    return {**sizes, "p_dropout": 0.0} if name in P_DROPOUT else sizes


def _port_model(case, **sizes):
    name, _, _ = CASES[case]
    model = MOVEMENTS_MODELS[name](**sizes)
    for module in model.modules():   # the rates fixed in the model
        if hasattr(module, "rate"):
            module.rate = 0.0
    if hasattr(model, "P_DROPOUT"):
        model.P_DROPOUT = 0.0
    return model


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """flax's ``nn.Dropout`` as the identity, and the JAX transformer's
    encoder layers built with attention dropout 0."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *args, **kwargs: inputs)
    monkeypatch.setattr(JT, "_EncoderLayer", functools.partial(
        JT._EncoderLayer, dropout=0.0))


def _inputs(clip_length):
    return np.random.default_rng(11).standard_normal(
        (B, clip_length, 26, 2)).astype(np.float32)


def _random_stats(tree, seed=5):
    """A ``batch_stats`` tree drawn away from 0 / 1."""
    rng = np.random.default_rng(seed)

    def draw(t):
        if "mean" in t:
            return {"mean": rng.normal(0.0, 0.5, t["mean"].shape)
                    .astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, t["var"].shape)
                    .astype(np.float32)}
        return {k: draw(v) for k, v in t.items()}
    return draw(tree)


@functools.lru_cache(maxsize=None)
def _jax_variables(case):
    name, sizes, clip_length = CASES[case]
    model = J_MODELS[name](**sizes)
    key = jax.random.PRNGKey(7)
    variables = jax.device_get(model.init(
        {"params": key, "dropout": key}, _inputs(clip_length),
        training=False))
    if "batch_stats" in variables:
        variables = {**variables,
                     "batch_stats": _random_stats(variables["batch_stats"])}
    return model, variables


def _load(model, variables):
    mutables = {"movements": {k: v for k, v in variables.items()
                              if k != "params"}}
    model.load_state_dict(import_flow_params(
        {"movements": variables["params"]}, device="cpu",
        mutables=mutables)["movements"])
    return model


def _flat(out):
    if isinstance(out, tuple):
        return np.concatenate([np.asarray(o).reshape(-1) for o in out])
    return np.asarray(out).reshape(-1)


def _assert_out_close(out, ref):
    out, ref = _flat(out), _flat(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=OUT_BAR * np.abs(ref).max())


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_flax_in_eval(case):
    _, sizes, clip_length = CASES[case]
    jmodel, variables = _jax_variables(case)
    ref = jmodel.apply(variables, _inputs(clip_length), training=False)
    model = _load(_port_model(case, **sizes), variables)
    # the flows' param_counts: the parameters alone, as flax's params
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.size(x) for x in jax.tree_util.tree_leaves(variables["params"]))
    with torch.no_grad():
        out = model(torch.from_numpy(_inputs(clip_length)))
    _assert_out_close(tuple(o.numpy() for o in out) if isinstance(out, tuple)
                      else out.numpy(), jax.device_get(ref))


#: the training-mode cases: every new model but VariationalGcn, whose
#: training noise is drawn from the flow's generator
TRAIN_CASES = [c for c in CASES if c != "VariationalGcn"]


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_model_matches_flax_in_training(case, no_flax_dropout):
    """Training-mode outputs and the updated ``batch_stats`` (flax
    ``mutable=["batch_stats"]``) against the port's output and the running
    statistics its forward updated in place."""
    _, _, clip_length = CASES[case]
    sizes = _no_dropout(case)
    jmodel = J_MODELS[CASES[case][0]](**sizes)
    _, variables = _jax_variables(case)
    x = _inputs(clip_length)
    mutable = ["batch_stats"] if "batch_stats" in variables else []
    ref, new = jmodel.apply(variables, x, training=True, mutable=mutable,
                            rngs={"dropout": jax.random.PRNGKey(0)})
    model = _load(_port_model(case, **sizes), variables)
    with torch.no_grad():
        out = model(torch.from_numpy(x), training=True,
                    **({"generator": torch.Generator()} if "generator" in
                       model.forward.__code__.co_varnames else {}))
    _assert_out_close(tuple(o.numpy() for o in out) if isinstance(out, tuple)
                      else out.numpy(), jax.device_get(ref))
    stats = batch_stats_to_state_dict(jax.device_get(new).get(
        "batch_stats", {}))
    before = batch_stats_to_state_dict(variables.get("batch_stats", {}))
    buffers = model.state_dict()
    assert set(stats) == set(buffers) - {n for n, _ in
                                         model.named_parameters()}
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(),
                                   rtol=STATS_RTOL, atol=1e-7, err_msg=k)
        assert not torch.equal(buffers[k], before[k])


def test_variational_gcn_draws_from_the_generator():
    """Evaluation takes z = mu (the flax model's output, above); training
    adds noise from the generator: the same seed, the same draw."""
    _, variables = _jax_variables("VariationalGcn")
    model = _load(_port_model("VariationalGcn"), variables)
    x = torch.from_numpy(_inputs(L))
    with torch.no_grad():
        runs = [model(x, training=True,
                      generator=torch.Generator().manual_seed(s))
                for s in (1, 1, 2)]
        mean = model(x)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], mean)
    with pytest.raises(ValueError, match="generator"):
        model(x, training=True)


def test_batch_norm_follows_flax():
    """Two training updates at momentum 0.9 over (B, L', C) and over rows,
    then evaluation, against flax ``nn.BatchNorm``; ``nn.BatchNorm1d``
    keeps the unbiased variance, so it would differ."""
    rng = np.random.default_rng(3)
    for shape in ((4, 7, 16), (12, 16)):
        xs = [rng.normal(1.0, 2.0, shape).astype(np.float32)
              for _ in range(2)]
        jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
        variables = jbn.init(jax.random.PRNGKey(0), xs[0])
        bn = BatchNorm(16, momentum=0.9)
        for x in xs:
            ref, new = jbn.apply(variables, x, mutable=["batch_stats"])
            variables = {**variables, **new}
            with torch.no_grad():
                out = bn(torch.from_numpy(x), training=True)
            np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
        stats = variables["batch_stats"]
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                                   rtol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                                   rtol=1e-6)
        ref = fnn.BatchNorm(use_running_average=True).apply(variables, xs[0])
        with torch.no_grad():
            out = bn(torch.from_numpy(xs[0]))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
        assert {n for n, _ in bn.named_buffers()} \
            == {"running_mean", "running_var"}


def test_bridge_layouts_and_refusals():
    """The flax layouts the new models bring: a temporal conv's (width, in,
    out) kernel -> Conv1d's (out, in, width), attention's DenseGeneral
    kernels and biases -> nn.Linear's, a norm's scale -> weight, the batch
    statistics -> running_mean / running_var, an image conv's kernel ->
    Conv2d's; a mutable collection or a kernel with no counterpart
    raises."""
    _, vp = _jax_variables("VideoPose3D")
    sd = flax_to_state_dict(vp["params"])
    kernel = vp["params"]["layer0_conv1"]["kernel"]
    np.testing.assert_array_equal(sd["layer0_conv1.weight"].numpy(),
                                  np.transpose(kernel, (2, 1, 0)))
    assert tuple(sd["BatchNorm_0.weight"].shape) == (64,)
    _, st = _jax_variables("SimpleTransformer")
    sd = flax_to_state_dict(st["params"])
    attn = st["params"]["_EncoderLayer_0"]["MultiHeadDotProductAttention_0"]
    pre = "_EncoderLayer_0.MultiHeadDotProductAttention_0"
    np.testing.assert_array_equal(sd[f"{pre}.query.weight"].numpy(),
                                  attn["query"]["kernel"].reshape(52, 52).T)
    np.testing.assert_array_equal(sd[f"{pre}.out.weight"].numpy(),
                                  attn["out"]["kernel"].reshape(52, 52).T)
    assert tuple(sd[f"{pre}.key.bias"].shape) == (52,)
    assert set(sd) == set(_port_model("SimpleTransformer", num_layers=2)
                          .state_dict())
    with pytest.raises(ValueError, match="mutable"):
        import_flow_params({"movements": vp["params"]}, device="cpu",
                           mutables={"movements": {"cache": {}}})
    with pytest.raises(ValueError, match="BatchNorm statistic"):
        batch_stats_to_state_dict({"BatchNorm_0": {"count": np.zeros(1)}})
    # an image conv's (kh, kw, in, out) kernel -> Conv2d's (out, in, kh,
    # kw) (the pose-estimation models); a 5-D kernel has no counterpart
    image = np.arange(24, dtype=np.float32).reshape(1, 2, 3, 4)
    np.testing.assert_array_equal(
        flax_to_state_dict({"conv": {"kernel": image}})["conv.weight"]
        .numpy(), image.transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="kernel"):
        flax_to_state_dict({"conv": {"kernel": np.zeros((1, 2, 3, 4, 5))}})


def test_registry_matches_jax():
    assert list(MOVEMENTS_MODELS) == list(J_MODELS)
    assert len(MOVEMENTS_MODELS) == 22


def test_video_pose_3d_flops_by_hand():
    """B=2, L=5, widths (3, 3), 8 channels, J=26: the input padded to 13
    frames; expand 13 -> 11 frames at 3 x 52 x 8, block 0 (dilation 3) 11
    -> 5 at 3 x 8 x 8 and 5 at 8 x 8, the head 5 frames at 8 x 78."""
    macs = 2 * (11 * 3 * 52 * 8 + 5 * 3 * 8 * 8 + 5 * 8 * 8 + 5 * 8 * 78)
    forward = 2 * macs
    assert video_pose_3d_flops(2, 5, 26, (3, 3), 8) == forward
    expand = 2 * 2 * 11 * 3 * 52 * 8
    assert video_pose_3d_flops(2, 5, 26, (3, 3), 8, train=True) \
        == 3 * forward - expand
    # BASELINE config 4's shape: about 202 GFLOP a forward
    assert 2.02e11 < video_pose_3d_flops(64, 81) < 2.03e11


# -- one training step of each flow against the JAX flow's --------------------

#: case -> (flow, loss mode)
STEP_CASES = {"VideoPose3D": "pose_lifting", "Baseline3DPose": "pose_lifting",
              "LinearAEResidual": "pose_lifting",
              "SimpleTransformer": "autoencoder"}
STEP_LOSS = {"pose_lifting": "loc_2d_3d", "autoencoder": "loc_2d"}
#: the leaves whose exact gradient is 0: a bias that reaches the loss only
#: through a training-mode BatchNorm (which takes the batch mean out), and
#: the attention's key bias (the softmax takes it out). Both packages give
#: rounding there (about 1e-8 of the model's largest gradient), so each is
#: held to 1e-6 of that largest gradient on both sides, not to the other.
ZERO_GRADS = {
    "Baseline3DPose": {"Dense_0.bias"} | {
        f"_LinearBlock_{i}.Dense_{j}.bias" for i in range(2)
        for j in range(2)},
    "LinearAEResidual": {f"Dense_{i}.bias" for i in range(7)},
    "SimpleTransformer": {
        f"_EncoderLayer_{i}.MultiHeadDotProductAttention_0.key.bias"
        for i in range(2)},
}


@functools.lru_cache(maxsize=None)
def _batch(clip_length):
    """A Carla2D3D batch with seeded numpy inputs (its targets as made)."""
    cfg = JD.Carla2D3DConfig(batch_size=B, clip_length=clip_length)
    inputs, targets, meta = jax.device_get(JD.generate_batch(
        jax.random.PRNGKey(3), cfg))
    return _inputs(clip_length), targets, meta


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _jax_step(case):
    """The JAX flow's state (random batch_stats), one training step's
    losses, gradients and new mutables, and its parameter counts."""
    flow_name = STEP_CASES[case]
    flow_cls = JPoseLiftingFlow if flow_name == "pose_lifting" \
        else JAutoencoderFlow
    flow = flow_cls(movements_model=J_MODELS[CASES[case][0]](
        **_no_dropout(case)),
        loss_modes=[JLossModes[STEP_LOSS[flow_name]]],
        movements_optimizer=JOptimizerSettings(lr=LR))
    batch = _batch(L)
    state = flow.init_state(jax.random.PRNGKey(1), batch)
    mutables = state.mutables
    if mutables["movements"]:
        mutables = {**mutables, "movements": {"batch_stats": _random_stats(
            jax.device_get(mutables["movements"]["batch_stats"]))}}

    def loss_fn(params):
        sliced, new = flow._inner_step(params, mutables, batch,
                                       training=True, rngs={
                                           "dropout": jax.random.PRNGKey(2)})
        losses = flow._compute_losses(sliced, sliced["targets"])
        return j_primary(losses, flow.requested_loss_modes)[1], (losses, new)
    (_, (losses, new)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params)
    return jax.device_get((state.params, mutables, losses, grads, new,
                           flow.param_counts(state)))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_training_step_matches_jax(case, no_flax_dropout):
    j_params, j_mutables, j_losses, j_grads, j_new, j_counts = \
        _jax_step(case)
    flow_name = STEP_CASES[case]
    flow_cls = PoseLiftingFlow if flow_name == "pose_lifting" \
        else AutoencoderFlow
    loss = STEP_LOSS[flow_name]
    flow = flow_cls(_port_model(case, **_no_dropout(case)),
                    loss_modes=[loss],
                    movements_optimizer=OptimizerSettings(lr=LR),
                    device="cpu")
    state = flow.init_state(import_flow_params(j_params, device="cpu",
                                               mutables=j_mutables))
    assert flow.param_counts(state) == j_counts
    buffers = {k for k, v in state.params["movements"].items()
               if not v.requires_grad}
    grouped = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    assert all(id(state.params["movements"][k]) not in grouped
               for k in buffers)
    _, logs = flow.training_step(state, _to_torch(_batch(L)))
    np.testing.assert_allclose(float(logs[f"train_loss/{loss}"]),
                               float(j_losses[loss]), rtol=1e-4)
    ref = flax_to_state_dict(j_grads["movements"])
    tree = state.params["movements"]
    assert set(ref) == set(tree) - buffers
    top = max(float(g.abs().max()) for g in ref.values())
    for k, g_ref in ref.items():
        g, g_ref = tree[k].grad.numpy(), g_ref.numpy()
        if k in ZERO_GRADS.get(case, ()):
            assert max(np.abs(g).max(), np.abs(g_ref).max()) <= 1e-6 * top, k
            continue
        scale = max(float(np.abs(g_ref).max()), 1e-8)
        np.testing.assert_allclose(g / scale, g_ref / scale, rtol=1e-4,
                                   atol=GRAD_ATOL, err_msg=k)
    stats = batch_stats_to_state_dict(j_new["movements"].get(
        "batch_stats", {}))
    assert set(stats) == buffers
    assert bool(buffers) == (case != "SimpleTransformer")
    for k, v in stats.items():
        assert tree[k].grad is None
        np.testing.assert_allclose(tree[k].numpy(), v.numpy(),
                                   rtol=STATS_RTOL, atol=1e-7, err_msg=k)


def test_fast_variance_loses_digits_on_carla_inputs_in_both_packages(
        no_flax_dropout):
    """F9 (``ROADMAP.md``): on a Carla2D3D batch's own (hips_neck
    normalised) inputs, VideoPose3D's training forward in float32 lands
    about 1e-4 of max |out| from a float64 evaluation of the same math, in
    the JAX package and in the port alike, while on seeded numpy inputs
    both stay within 1e-6 of it."""
    sizes = _no_dropout("VideoPose3D")
    jmodel = J_MODELS["VideoPose3D"](**sizes)
    _, variables = _jax_variables("VideoPose3D")
    cfg = JD.Carla2D3DConfig(batch_size=B, clip_length=L)
    carla = np.array(jax.device_get(JD.generate_batch(
        jax.random.PRNGKey(3), cfg))[0])
    errors = {}
    for name, x in (("carla", carla), ("numpy", _inputs(L))):
        ref, _ = jmodel.apply(variables, x, training=True,
                              mutable=["batch_stats"])
        outs = {}
        for dtype in (torch.float32, torch.float64):
            model = _load(_port_model("VideoPose3D", **sizes),
                          variables).to(dtype)
            with torch.no_grad():
                outs[dtype] = model(torch.from_numpy(x).to(dtype),
                                    training=True).double().numpy()
        exact = outs[torch.float64]
        scale = np.abs(exact).max()
        errors[name] = (np.abs(np.asarray(ref) - exact).max() / scale,
                        np.abs(outs[torch.float32] - exact).max() / scale)
    assert all(e < 1e-6 for e in errors["numpy"]), errors
    assert all(3e-5 < e < 1e-3 for e in errors["carla"]), errors
