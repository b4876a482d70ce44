"""Port parity for the pose-estimation slice, on the CPU: every module
against the JAX package on seeded numpy inputs and the same weights
(``import_flow_params``, running statistics drawn away from 0 / 1).

* The heatmap ops within 1e-6, the argmax decode exactly (ties included).
* ``ResNet`` at ``stage_sizes=(1, 1, 1, 1)`` and output stride 8, 16 and
  None, evaluation and training: 1e-4 of max |out|, the updated running
  statistics within 1e-5.
* ``UniPoseLSTM(backbone="resnet50")`` at 1 x 2 x 64 x 64 (its resize to
  the stride shrinks 16 -> 8, antialiased), ``P0``,
  ``AvPedestrianPoseTransformer`` and ``Linear``: 1e-4 of max |out|, in
  evaluation and in training (flax's dropout patched to the identity and
  the port's rates at 0).
* ``PoseEstimationFlow.training_step`` on UniPoseLSTM (its backbone cut
  to one block a stage in both packages) with the ``heatmaps`` loss
  against the JAX flow's loss (rtol 1e-4) and gradients (1e-4 of
  each one's largest, the exactly-zero leaves within 1e-6 of the model's
  largest) and running statistics; the eval step's ``projection_2d``
  (exactly) and ``projection_2d_transformed``.

Training mode is compared in float64 on both sides (JAX under
``jax.enable_x64``, the port's modules and flow in float64): its
BatchNorms normalise by the batch's statistics over 2 frames, and flax's
fast variance (``mean(x^2) - mean(x)^2``) cancels digits there, so that
in float32 both packages land up to 5e-4 of max |out| (UniPoseLSTM on
its whole ResNet-50) and over 100 % (P0, whose BatchNorms see one value
a channel a frame) from the float64 evaluation of the same math, by
amounts that move with the order of the sums (eager or jitted JAX).
``test_float32_training_forward_is_within_the_bar_of_float64`` holds the
float32 path where it is well conditioned: UniPoseLSTM on the cut
backbone.

One case runs the whole ResNet-50 (UniPoseLSTM in evaluation); the others
cut it to one bottleneck block a stage in both packages
(``small_backbone``), which keeps the file's time down; the backbone's
depth is held by that case and by ``test_resnet_matches_jax``.
* The loss alone against the JAX loss with and without the mask; serving
  and export of the flow against the JAX closure.

The weight importers, the video data modules and the CLI are in
``tests/test_torch_pose_estimation_data.py``.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.flows.pose_estimation import \
    PoseEstimationFlow as JPoseEstimationFlow
from pedestrians_video_2_carla_tpu.losses import LossContext as JLossContext
from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
from pedestrians_video_2_carla_tpu.losses import loss_heatmaps as j_loss
from pedestrians_video_2_carla_tpu.losses import primary_loss as j_primary
from pedestrians_video_2_carla_tpu.models.backbones import resnet as JR
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.pose_estimation import \
    POSE_ESTIMATION_MODELS as J_MODELS
from pedestrians_video_2_carla_tpu.models.pose_estimation import \
    regular as JRegular
from pedestrians_video_2_carla_tpu.ops import heatmaps as JH
from pedestrians_video_2_carla_tpu.skeletons.carla import CARLA_SKELETON

from pedestrians_video_2_carla_torch.flows.pose_estimation import \
    PoseEstimationFlow
from pedestrians_video_2_carla_torch.losses import LossContext, loss_heatmaps
from pedestrians_video_2_carla_torch.models.backbones import resnet as TR
from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
from pedestrians_video_2_carla_torch.models.jax_import import (
    batch_stats_to_state_dict, flax_to_state_dict, import_flow_params)
from pedestrians_video_2_carla_torch.models.pose_estimation import \
    POSE_ESTIMATION_MODELS as T_MODELS
from pedestrians_video_2_carla_torch.ops import heatmaps as TH
from .torch_threads import limit_torch_threads

limit_torch_threads()

OUT_BAR = 1e-4
STATS_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
ZERO_BAR = 1e-6
HEATMAP_ATOL = 1e-6
B, L, H, W = 1, 2, 64, 64
LR = 1e-3


def _frames(shape=(B, L, H, W, 3), seed=0):
    """Seeded NHWC frames (the JAX layout)."""
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(x):
    """(..., H, W, C) numpy -> (..., C, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _close(got, ref, bar=OUT_BAR, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=bar * scale,
                               err_msg=msg)


def _random_stats(tree, seed=7):
    """flax ``batch_stats`` drawn away from mean 0 / var 1."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (rng.uniform(0.5, 1.5, v.shape) if np.all(v == 1)
                   else rng.normal(scale=0.1, size=v.shape)).astype(
                       np.float32), jax.device_get(tree))


def _random_scales(params, seed=8):
    """BatchNorm scales and biases drawn away from 1 / 0."""
    rng = np.random.default_rng(seed)

    def walk(tree, bn=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, bn or k.startswith(("bn", "BatchNorm",
                                                     "downsample_bn")))
            elif bn and k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif bn and k == "bias":
                out[k] = rng.normal(scale=0.1, size=v.shape).astype(
                    np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(jax.device_get(params))


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """flax's ``nn.Dropout`` as the identity, and the transformer layers
    of the JAX AvPedestrianPoseTransformer built with dropout 0."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *args, **kwargs: inputs)
    monkeypatch.setattr(JRegular, "_EncoderLayer", functools.partial(
        JRegular._EncoderLayer, dropout=0.0))


def _no_port_dropout(model):
    for module in model.modules():
        if hasattr(module, "rate"):
            module.rate = 0.0
    if hasattr(model, "P_DROPOUT"):
        model.P_DROPOUT = 0.0
    return model


def _port(module, params, stats=None):
    """``module`` with the flax ``params`` and ``batch_stats`` loaded."""
    sd = import_flow_params(
        {"m": params}, device="cpu",
        mutables=None if stats is None else {"m": {"batch_stats": stats}}
    )["m"]
    assert set(sd) == set(module.state_dict()), \
        set(sd) ^ set(module.state_dict())
    module.load_state_dict(sd)
    return module


#: the cut backbone: one bottleneck block a stage
SMALL_STAGES = (1, 1, 1, 1)


def _small_backbone(monkeypatch):
    """Every pose-estimation model's "resnet50" as a ResNet of one block a
    stage (its widths, strides and dilations as they are), in both
    packages: UniPoseLSTM's, P0's and AvPedestrianPoseTransformer's."""
    from pedestrians_video_2_carla_torch.models.pose_estimation import \
        regular as TRegular
    from pedestrians_video_2_carla_torch.models.pose_estimation import \
        unipose_lstm as TU
    from pedestrians_video_2_carla_tpu.models.pose_estimation import \
        unipose_lstm as JU
    small_jax = functools.partial(JR.ResNet, stage_sizes=SMALL_STAGES)
    small_port = functools.partial(TR.ResNet, stage_sizes=SMALL_STAGES)
    monkeypatch.setattr(JU, "resnet50", small_jax)
    monkeypatch.setattr(JRegular, "resnet50", small_jax)
    monkeypatch.setitem(TU.BACKBONES, "resnet50", small_port)
    monkeypatch.setattr(TRegular, "resnet50", small_port)


@pytest.fixture
def small_backbone(monkeypatch):
    _small_backbone(monkeypatch)


# -- the heatmap ops -----------------------------------------------------------

def _keypoints(seed=0, shape=(2, 3, 26), size=(32, 24)):
    rng = np.random.default_rng(seed)
    kp = (rng.uniform(0, 1, shape + (2,)) * size).astype(np.float32)
    kp[0, 0, 3] = 0            # missing joints
    kp[1, 2, :5] = 0
    kp[0, 1, 7] = [40.0, -5.0]  # off the canvas
    return kp


@pytest.mark.parametrize("background", [True, False])
def test_gaussian_heatmaps_match_jax(background):
    kp = _keypoints()
    for size, sigma in (((32, 24), 2.0), ((8, 8), 3.0)):
        ref = np.asarray(JH.gaussian_heatmaps(jnp.asarray(kp), size, sigma,
                                              background))
        got = TH.gaussian_heatmaps(torch.from_numpy(kp), size, sigma,
                                   background).numpy()
        assert got.shape == ref.shape == (2, 3, 26 + background,
                                          size[1], size[0])
        np.testing.assert_allclose(got, ref, rtol=0, atol=HEATMAP_ATOL)
        assert not got[0, 0, 3].any() and not got[1, 2, :5].any()
        assert got[..., :26, :, :][got[..., :26, :, :] > 0].min() \
            >= TH.TAIL


def test_keypoints_from_heatmaps_match_jax_exactly():
    """The same maps in both: the decode is exact, the first largest value
    wins a tie (a flat map decodes to (0, 0), a map with two equal peaks
    to the first in row-major order)."""
    rng = np.random.default_rng(1)
    maps = np.round(rng.uniform(0, 1, (2, 3, 27, 6, 5)), 1).astype(
        np.float32)
    maps[0, 0, 0] = 0.5
    maps[0, 0, 1] = 0
    maps[0, 0, 1, 4, 1] = maps[0, 0, 1, 2, 3] = 2.0
    for bg in (True, False):
        ref = np.asarray(JH.keypoints_from_heatmaps(jnp.asarray(maps), bg))
        got = TH.keypoints_from_heatmaps(torch.from_numpy(maps), bg).numpy()
        np.testing.assert_array_equal(got, ref)
    assert got[0, 0, 0].tolist() == [0.0, 0.0]
    assert got[0, 0, 1].tolist() == [3.0, 2.0]


def test_downsample_heatmaps_matches_jax():
    maps = _frames((2, 3, 27, 16, 12), seed=2)
    for factor in (2, 4):
        np.testing.assert_allclose(
            TH.downsample_heatmaps(torch.from_numpy(maps), factor).numpy(),
            np.asarray(JH.downsample_heatmaps(jnp.asarray(maps), factor)),
            rtol=0, atol=HEATMAP_ATOL)


@pytest.mark.parametrize("mask", [True, False])
def test_heatmaps_loss_matches_jax(mask):
    """The loss alone, with missing joints (all-zero target maps)."""
    rng = np.random.default_rng(3)
    gt = np.asarray(JH.gaussian_heatmaps(jnp.asarray(_keypoints(4)),
                                         (8, 6), 1.5))
    pred = (gt + rng.normal(scale=0.2, size=gt.shape)).astype(np.float32)
    ref = j_loss(JLossContext(
        input_nodes=CARLA_SKELETON, output_nodes=CARLA_SKELETON,
        sliced={"heatmaps": jnp.asarray(pred)},
        targets={"heatmaps": jnp.asarray(gt)}, mask_missing_joints=mask))
    got = loss_heatmaps(LossContext(
        input_nodes=CARLA_SKELETON, output_nodes=CARLA_SKELETON,
        sliced={"heatmaps": torch.from_numpy(pred)},
        targets={"heatmaps": torch.from_numpy(gt)},
        mask_missing_joints=mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    assert loss_heatmaps(LossContext(
        input_nodes=CARLA_SKELETON, output_nodes=CARLA_SKELETON,
        sliced={}, targets={"heatmaps": torch.from_numpy(gt)})) is None


# -- the backbone --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_resnet(output_stride, training):
    x = _frames((2, 37, 45, 3), seed=5)
    model = JR.ResNet(stage_sizes=(1, 1, 1, 1), output_stride=output_stride)
    variables = model.init(jax.random.PRNGKey(0), x, training=False)
    params = _random_scales(variables["params"])
    stats = _random_stats(variables["batch_stats"])
    if training:
        (high, low), new = model.apply(
            {"params": params, "batch_stats": stats}, x, training=True,
            mutable=["batch_stats"])
        new = jax.device_get(new["batch_stats"])
    else:
        high, low = model.apply({"params": params, "batch_stats": stats}, x,
                                training=False)
        new = None
    return x, params, stats, jax.device_get((high, low)), new


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("output_stride", [8, 16, None])
def test_resnet_matches_jax(output_stride, training):
    x, params, stats, (high, low), new = _jax_resnet(output_stride,
                                                     training)
    model = _port(TR.ResNet(stage_sizes=(1, 1, 1, 1),
                            output_stride=output_stride), params, stats)
    with torch.no_grad():
        got_high, got_low = model(_nchw(x), training=training)
    _close(got_high.numpy(), np.moveaxis(high, -1, 1), msg="high")
    _close(got_low.numpy(), np.moveaxis(low, -1, 1), msg="low")
    buffers = {k: v for k, v in model.state_dict().items()
               if "running_" in k}
    want = batch_stats_to_state_dict(stats if new is None else new)
    assert set(buffers) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), rtol=0,
                                   atol=STATS_ATOL, err_msg=k)
        if training:   # the batch's statistics moved them
            assert not np.array_equal(v.numpy(), batch_stats_to_state_dict(
                stats)[k].numpy())


# -- the models ----------------------------------------------------------------

#: (port and JAX constructor arguments) of each model's case
MODEL_CASES = {"UniPoseLSTM": {"backbone": "resnet50"},
               "P0": {}, "AvPedestrianPoseTransformer": {}, "Linear": {}}
#: the one case on the whole ResNet-50; the others cut it to one block a
#: stage in both packages (``small_backbone``): the backbone's depth is
#: held here and in ``test_resnet_matches_jax``, the cases' own layers
#: everywhere
FULL_BACKBONE = ("UniPoseLSTM", False)


def _f64(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _jax_variables(name, small):
    """Seeded frames and the JAX model's variables, its BatchNorms' scales
    and statistics drawn away from their inits (``small``: under
    ``small_backbone``)."""
    x = _frames()
    model = J_MODELS[name](**MODEL_CASES[name])
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "dropout": jax.random.PRNGKey(1)}, x,
                           training=False)
    params = _random_scales(variables["params"])
    stats = _random_stats(variables["batch_stats"]) \
        if "batch_stats" in variables else None
    return x, params, stats


@functools.lru_cache(maxsize=None)
def _jax_model(name, training, small, dtype=np.float32):
    """The JAX model's output (and, training, its new running statistics)
    in ``dtype``; float64 under ``jax.enable_x64``."""
    x, params, stats = _jax_variables(name, small)
    model = J_MODELS[name](**MODEL_CASES[name])
    if dtype == np.float64:
        x, params, stats = _f64((x, params, stats))
    mutables = {} if stats is None else {"batch_stats": stats}
    with jax.enable_x64(dtype == np.float64):
        if training:
            out, new = jax.jit(functools.partial(
                model.apply, training=True, mutable=["batch_stats"]))(
                {"params": params, **mutables}, x,
                rngs={"dropout": jax.random.PRNGKey(2)})
            new = jax.device_get(new.get("batch_stats"))
        else:
            out, new = model.apply({"params": params, **mutables}, x,
                                   training=False), None
        out = np.asarray(out)
    assert out.dtype == dtype
    return x, params, stats, out, new


def _port_model(name):
    kwargs = dict(MODEL_CASES[name])
    if name == "Linear":
        kwargs["video_size"] = (H, W)
    return _no_port_dropout(T_MODELS[name](
        generator=torch.Generator().manual_seed(0), **kwargs))


def _port_apply(name, x, params, stats, training, dtype=torch.float32):
    """The port's model with the JAX weights, in ``dtype``, on ``x``:
    (output, the model)."""
    model = _port(_port_model(name), params, stats).to(dtype)
    if dtype == torch.float64:
        model.load_state_dict(import_flow_params(
            {"m": _f64(params)}, device="cpu", mutables=None if stats is None
            else {"m": {"batch_stats": _f64(stats)}})["m"])
    with torch.no_grad():
        out = model(_nchw(x).to(dtype), training=training,
                    **({"generator": torch.Generator()}
                       if name in ("P0", "AvPedestrianPoseTransformer")
                       else {}))
    return out.numpy(), model


@pytest.mark.parametrize("name,training", [
    (name, training) for name in MODEL_CASES for training in (False, True)
    if (name, training) != ("UniPoseLSTM", True)],
    ids=lambda v: {False: "eval", True: "train"}.get(v, v))
def test_models_match_jax(name, training, no_flax_dropout, monkeypatch):
    """Evaluation in float32, training in float64 (module docstring).
    UniPoseLSTM's training forward is held by
    ``test_training_step_matches_jax``, with its gradients."""
    small = (name, training) != FULL_BACKBONE
    if small:
        _small_backbone(monkeypatch)
    dtype = np.float64 if training else np.float32
    x, params, stats, ref, new = _jax_model(name, training, small, dtype)
    got, model = _port_apply(name, x, params, stats, training,
                             torch.float64 if training else torch.float32)
    want_shape = (B, L, 27, H // 8, W // 8) if name == "UniPoseLSTM" \
        else (B, L, 26, 2)
    assert ref.shape == want_shape
    _close(got, ref, msg=name)
    if new is not None:
        buffers = model.state_dict()
        for k, v in batch_stats_to_state_dict(new).items():
            np.testing.assert_allclose(buffers[k].numpy(), v.numpy(),
                                       rtol=0, atol=STATS_ATOL, err_msg=k)


def test_float32_training_forward_is_within_the_bar_of_float64(
        no_flax_dropout, small_backbone):
    """UniPoseLSTM's float32 training forward (its backbone cut) within
    the bar of the float64 evaluation of the same math, in the port as in
    the JAX package."""
    x, params, stats, ref32, _ = _jax_model("UniPoseLSTM", True, True)
    ref64 = _jax_model("UniPoseLSTM", True, True, np.float64)[3]
    got32, _ = _port_apply("UniPoseLSTM", x, params, stats, True)
    scale = np.abs(ref64).max()
    assert np.abs(ref32 - ref64).max() / scale <= OUT_BAR
    assert np.abs(got32 - ref64).max() / scale <= OUT_BAR


def test_unipose_resizes_as_jax_image_resize():
    """The shrinking resize is antialiased (as ``jax.image.resize``), the
    growing one plain bilinear: both within 1e-6 of JAX's; the plain
    bilinear on the shrink is not."""
    from pedestrians_video_2_carla_torch.models.pose_estimation.unipose_lstm \
        import resize_bilinear
    x = _frames((2, 16, 16, 5), seed=9)
    for size in ((8, 8), (64, 64), (8, 12)):
        ref = np.asarray(jax.image.resize(jnp.asarray(x),
                                          (2,) + size + (5,), "bilinear"))
        got = resize_bilinear(_nchw(x), size).numpy()
        np.testing.assert_allclose(got, np.moveaxis(ref, -1, 1), rtol=0,
                                   atol=1e-5)
    plain = torch.nn.functional.interpolate(_nchw(x), size=(8, 8),
                                            mode="bilinear",
                                            align_corners=False).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 8, 8, 5),
                                      "bilinear"))
    assert np.abs(plain - np.moveaxis(ref, -1, 1)).max() > 1e-2


def test_registry_and_flags():
    assert list(T_MODELS) == list(J_MODELS)
    unipose = T_MODELS["UniPoseLSTM"](backbone="resnet50")
    assert unipose.needs_heatmaps and unipose.ResNet_0.conv1.weight.shape \
        == (64, 4, 7, 7)
    assert not T_MODELS["Linear"](video_size=(8, 8)).needs_heatmaps
    with pytest.raises(ValueError, match="backbone"):
        T_MODELS["UniPoseLSTM"](backbone="resnet18")
    with pytest.raises(ValueError, match="output_stride"):
        TR.ResNet(output_stride=4)


# -- the flow ------------------------------------------------------------------

def _flow_batch():
    """Frames (NHWC) and heatmap targets at the model's canvas, with a
    missing joint, and the keypoints they were drawn from."""
    x = _frames(seed=11)
    rng = np.random.default_rng(12)
    kp = (rng.uniform(0.2, 0.8, (B, L, 26, 2)) * [W, H]).astype(np.float32)
    kp[0, 1, 4] = 0
    hm = np.asarray(JH.gaussian_heatmaps(jnp.asarray(kp / 8.0),
                                         (W // 8, H // 8), 1.0))
    targets = {"heatmaps": hm, "projection_2d": kp}
    meta = {"age_gender_idx": np.zeros(B, np.int32)}
    return x, targets, meta


def _jax_flow():
    return JPoseEstimationFlow(
        movements_model=J_MODELS["UniPoseLSTM"](backbone="resnet50"),
        loss_modes=[JLossModes.heatmaps],
        movements_optimizer=JOptimizerSettings(lr=LR))


def _flow_variables(dtype=np.float32):
    """The flow's parameter and mutable trees (the model's BatchNorms drawn
    away from their inits, no trajectory), under ``small_backbone``."""
    _, params, stats = _jax_variables("UniPoseLSTM", True)
    tree = ({"movements": params, "trajectory": {}},
            {"movements": {"batch_stats": stats}, "trajectory": {}})
    return _f64(tree) if dtype == np.float64 else tree


@functools.lru_cache(maxsize=None)
def _jax_flow_step():
    """One training step's losses, gradients and new running statistics
    of the JAX flow, in float64."""
    flow = _jax_flow()
    params, mutables = _flow_variables(np.float64)
    batch = _f64(_flow_batch())

    def loss_fn(p):
        sliced, new = flow._inner_step(p, mutables, batch, training=True,
                                       rngs=None)
        losses = flow._compute_losses(sliced, sliced["targets"])
        return j_primary(losses, flow.requested_loss_modes)[1], (losses, new)
    with jax.enable_x64(True):
        (_, (losses, new)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        return jax.device_get((losses, grads, new))


@functools.lru_cache(maxsize=None)
def _jax_flow_eval():
    sliced, _ = _jax_flow()._inner_step(*_flow_variables(), _flow_batch(),
                                        training=False, rngs=None)
    return jax.device_get({k: sliced[k] for k in (
        "heatmaps", "projection_2d", "projection_2d_transformed")})


def _port_flow(dtype=torch.float32):
    return PoseEstimationFlow(
        T_MODELS["UniPoseLSTM"](
            backbone="resnet50",
            generator=torch.Generator().manual_seed(0)).to(dtype),
        loss_modes=["heatmaps"], movements_optimizer=OptimizerSettings(lr=LR),
        device="cpu")


def _port_batch(dtype=torch.float32):
    x, targets, meta = _flow_batch()
    return (_nchw(x).to(dtype),
            {k: torch.from_numpy(v).to(dtype) for k, v in targets.items()},
            {k: torch.from_numpy(v) for k, v in meta.items()})


def test_training_step_matches_jax(small_backbone):
    """In float64 on both sides (module docstring)."""
    j_losses, j_grads, j_new = _jax_flow_step()
    j_params, j_mutables = _flow_variables(np.float64)
    flow = _port_flow(torch.float64)
    assert flow.needs_heatmaps
    state = flow.init_state(import_flow_params(j_params, device="cpu",
                                               mutables=j_mutables))
    assert all(v.dtype == torch.float64
               for v in state.params["movements"].values())
    _, logs = flow.training_step(state, _port_batch(torch.float64))
    assert set(logs) == {"train_loss/heatmaps", "train_loss/primary"}
    np.testing.assert_allclose(float(logs["train_loss/heatmaps"]),
                               float(j_losses["heatmaps"]), rtol=1e-4)
    tree = state.params["movements"]
    buffers = {k for k, v in tree.items() if not v.requires_grad}
    ref = flax_to_state_dict(j_grads["movements"])
    assert set(ref) == set(tree) - buffers
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    zero = set()
    for k, g_ref in ref.items():
        g, g_ref = tree[k].grad.numpy(), g_ref.numpy()
        scale = float(np.abs(g_ref).max())
        if scale <= ZERO_BAR * top:   # an exactly-zero leaf, up to rounding
            zero.add(k)
            assert np.abs(g).max() <= ZERO_BAR * top, k
            continue
        np.testing.assert_allclose(g / scale, g_ref / scale, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    # WASP's four branch projections' biases: a per-channel constant that
    # the BatchNorm after the fusing conv takes out again
    assert zero == {f"WASP_0.Conv_{i}.bias" for i in range(4)}
    stats = batch_stats_to_state_dict(j_new["movements"]["batch_stats"])
    assert set(stats) == buffers
    for k, v in stats.items():
        np.testing.assert_allclose(tree[k].numpy(), v.numpy(), rtol=0,
                                   atol=STATS_ATOL, err_msg=k)


def test_eval_step_matches_jax(small_backbone):
    j_sliced = _jax_flow_eval()
    flow = _port_flow()
    params, mutables = _flow_variables()
    params = import_flow_params(params, device="cpu", mutables=mutables)
    sliced = flow._inner_step(params, _port_batch(), training=False)
    _close(sliced["heatmaps"].numpy(), j_sliced["heatmaps"], msg="heatmaps")
    np.testing.assert_array_equal(sliced["projection_2d"].numpy(),
                                  j_sliced["projection_2d"])
    np.testing.assert_allclose(
        sliced["projection_2d_transformed"].numpy(),
        j_sliced["projection_2d_transformed"], rtol=1e-6, atol=1e-6)
    loss, preds, _ = flow.eval_step(params, _port_batch())
    assert set(preds) >= {"projection_2d", "projection_2d_transformed"}
    assert flow.initial_preds(_port_batch()[0], {}) == {}


def test_serving_matches_jax_and_exports(small_backbone, tmp_path):
    """``make_inference_fn`` on the flow against the JAX closure (the same
    weights, frames without targets), and the ``torch.export`` artifact of
    the same closure, bit for bit on the CPU."""
    from types import SimpleNamespace

    from pedestrians_video_2_carla_torch import serving as TS
    from pedestrians_video_2_carla_tpu import serving as JS
    params, mutables = _flow_variables()
    x, _, meta = _flow_batch()
    ref = jax.device_get(JS.make_inference_fn(
        _jax_flow(), SimpleNamespace(params=params, mutables=mutables))(
        x, meta["age_gender_idx"]))
    flow = _port_flow()
    weights = import_flow_params(params, device="cpu", mutables=mutables)
    inputs, agi = _nchw(x), torch.from_numpy(meta["age_gender_idx"])
    got = TS.make_inference_fn(flow, weights)(inputs, agi)
    assert set(got) == set(ref) == {"projection_2d",
                                    "projection_2d_transformed"}
    np.testing.assert_array_equal(got["projection_2d"].numpy(),
                                  ref["projection_2d"])
    np.testing.assert_allclose(got["projection_2d_transformed"].numpy(),
                               ref["projection_2d_transformed"], rtol=1e-6,
                               atol=1e-6)
    path = TS.export_inference(flow, weights, inputs, agi,
                               str(tmp_path / "model.pt2"))
    infer, info = TS.load_inference(path, device="cpu")
    assert info["flow"] == "PoseEstimationFlow"
    assert info["input_shapes"][0] == [B, L, 3, H, W]
    served = infer(inputs, agi)
    for k, v in got.items():
        assert torch.equal(served[k], v), k
