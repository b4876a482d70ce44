"""Port parity for the input preprocessing graph and the pose augmentation,
on the CPU: ``ops/preprocessing.py::process_batch`` against the JAX
package's over its deterministic configurations (skeleton remap,
confidence channel on and off, each normalisation, ``clip_length`` equal to
the joint count), and ``flip_pose`` / ``rotate_pose`` / ``AugmentPose.invert``
against the JAX functions on the same given flips and angles.

The random parts draw from a ``torch.Generator`` where the JAX package
draws from its PRNG key (``ROADMAP.md`` F3), so they are checked by
property and by distribution: the flip rate, the range of the angles, the
missing-joint rate, dropped joints staying zero, the clean targets
untouched by the noise, and ``invert`` getting the pose back.

Bars: atol 1e-5 on coordinates, shift and scale, with rtol 1e-6 beside it
for values in pixels (one float32 rounding of a 150-px value is 1.5e-5);
presence masks and the flips exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.ops import augmentation as JA
from pedestrians_video_2_carla_tpu.ops import preprocessing as JP
from pedestrians_video_2_carla_tpu.ops.tensors import get_bboxes as j_bboxes
from pedestrians_video_2_carla_tpu.skeletons import \
    BODY_25_SKELETON as J_BODY_25
from pedestrians_video_2_carla_tpu.skeletons import \
    CARLA_SKELETON as J_CARLA

from pedestrians_video_2_carla_torch.ops import augmentation as A
from pedestrians_video_2_carla_torch.ops import preprocessing as P
from pedestrians_video_2_carla_torch.ops.tensors import get_bboxes
from pedestrians_video_2_carla_torch.skeletons import (BODY_25_SKELETON,
                                                       CARLA_SKELETON)
from .torch_threads import limit_torch_threads

limit_torch_threads()

B, L = 3, 5
ATOL, RTOL = 1e-5, 1e-6
SKELETONS = {"CARLA": (CARLA_SKELETON, J_CARLA),
             "BODY_25": (BODY_25_SKELETON, J_BODY_25)}
#: id -> (data skeleton, input skeleton, channels of the raw detections,
#: clip length, PreprocessingConfig fields)
CONFIGS = {
    "identity": ("CARLA", "CARLA", 2, L, dict(transform="none")),
    "hips_neck": ("CARLA", "CARLA", 2, L, dict()),
    "bbox": ("CARLA", "CARLA", 2, L, dict(transform="bbox")),
    "hips_neck_bbox": ("BODY_25", "BODY_25", 2, L,
                       dict(transform="hips_neck_bbox")),
    "remap": ("BODY_25", "CARLA", 2, L, dict(transform="none")),
    "remap_hips_neck": ("BODY_25", "CARLA", 2, L, dict()),
    "remap_presence_channel": ("BODY_25", "CARLA", 2, L,
                               dict(needs_confidence=True)),
    "remap_raw_confidence": ("BODY_25", "CARLA", 3, L,
                             dict(needs_confidence=True)),
    "strip_raw_confidence": ("BODY_25", "CARLA", 3, L, dict()),
    "clip_length_is_joint_count": ("BODY_25", "CARLA", 2, 25, dict()),
}


def _close(got, ref, err_msg=""):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


def _raw(skeleton, channels, clip_length, seed=1):
    """Seeded detections in pixels, with some joints missing (exact zeros,
    the confidence too) and one frame whose hips are missing."""
    rng = np.random.default_rng(seed)
    J = len(skeleton)
    raw = (100.0 + 50.0 * rng.standard_normal(
        (B, clip_length, J, channels))).astype(np.float32)
    if channels == 3:
        raw[..., 2] = rng.uniform(0.05, 1.0, raw.shape[:-1])
    raw[rng.uniform(size=raw.shape[:-1]) < 0.15] = 0.0
    raw[0, 1, skeleton.get_hips_indices()] = 0.0
    return raw


def _cfg(name, port: bool):
    data, inp, channels, _, fields = CONFIGS[name]
    side = 0 if port else 1
    cls = P.PreprocessingConfig if port else JP.PreprocessingConfig
    if not port:
        # the JAX config names the raw confidence channel; the port reads
        # it off the inputs' last dimension
        fields = dict(fields, has_confidence_channel=channels == 3)
    return cls(data_nodes=SKELETONS[data][side],
               input_nodes=SKELETONS[inp][side], **fields)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_process_batch_matches_jax(name):
    data, _, channels, clip_length, _ = CONFIGS[name]
    raw = _raw(SKELETONS[data][0], channels, clip_length)
    ref_inputs, ref_targets = jax.device_get(JP.process_batch(
        jax.random.PRNGKey(0), raw, _cfg(name, False), True))
    cfg = _cfg(name, True)
    # a training batch without augmentation draws nothing
    assert P.is_deterministic(cfg, True)
    inputs, targets = P.process_batch(None, torch.from_numpy(raw), cfg, True)
    assert tuple(inputs.shape) == ref_inputs.shape
    assert set(targets) == set(ref_targets)
    J = len(cfg.input_nodes)
    assert inputs.shape[-2] == J and inputs.shape[-1] == \
        (3 if cfg.needs_confidence else 2)
    got = inputs.numpy()
    _close(got[..., :2], ref_inputs[..., :2])
    if got.shape[-1] == 3:         # presence (or the raw confidence): exact
        np.testing.assert_array_equal(got[..., 2], ref_inputs[..., 2])
    for k, ref in ref_targets.items():
        _close(targets[k].numpy(), ref, err_msg=k)
    if cfg.transform != "none":     # shift/scale keep their (B, L) frames
        assert tuple(targets["projection_2d_scale"].shape) == raw.shape[:2]


def test_presence_is_read_before_normalisation():
    """A dropped joint is (0, 0) only before the shift/scale moves it:
    the presence channel must say 0 there and 1 on every present joint."""
    raw = _raw(CARLA_SKELETON, 2, L)
    cfg = P.PreprocessingConfig(data_nodes=CARLA_SKELETON,
                                input_nodes=CARLA_SKELETON,
                                needs_confidence=True)
    inputs, _ = P.process_batch(None, torch.from_numpy(raw), cfg)
    present = np.any(raw != 0, axis=-1).astype(np.float32)
    np.testing.assert_array_equal(inputs[..., 2].numpy(), present)


def test_remap_nodes_same_skeleton_is_identity():
    cfg = _cfg("hips_neck", True)
    raw = torch.zeros(2, 3, 26, 2)
    assert P.remap_nodes(raw, cfg) is raw


# -- augmentation against the JAX functions, given flips and angles -------------
def _pose(C=2, seed=4, Bp=4, missing=True):
    rng = np.random.default_rng(seed)
    pose = (rng.normal(size=(Bp, L, 25, C)) * 50 + 300).astype(np.float32)
    if missing:
        pose[0, :, 7] = 0.0                   # a missing joint
        pose[-1, 1, 3] = 0.0
    return pose


FLIPS = np.array([True, False, True, True])
ANGLES = np.array([10.0, -7.5, 0.0, 33.0], np.float32)
CLIP_SIZE = np.array([[800.0, 600.0], [640.0, 480.0], [800.0, 600.0],
                      [1920.0, 1080.0]], np.float32)


@pytest.mark.parametrize("channels", [2, 3])
@pytest.mark.parametrize("with_bboxes,with_clip_size",
                         [(False, False), (True, False), (True, True)],
                         ids=["no_bboxes", "bboxes", "clip_size"])
def test_flip_pose_matches_jax(with_bboxes, with_clip_size, channels):
    pose = _pose(channels)
    bboxes = np.asarray(j_bboxes(jnp.asarray(pose[..., :2]))) \
        if with_bboxes else None
    clip_size = CLIP_SIZE if with_clip_size else None
    ref, ref_bb = JA.flip_pose(
        jnp.asarray(pose), jnp.asarray(FLIPS), J_BODY_25,
        None if bboxes is None else jnp.asarray(bboxes),
        None if clip_size is None else jnp.asarray(clip_size))
    got, got_bb = A.flip_pose(
        torch.from_numpy(pose), torch.from_numpy(FLIPS), BODY_25_SKELETON,
        None if bboxes is None else torch.from_numpy(bboxes),
        None if clip_size is None else torch.from_numpy(clip_size))
    _close(got.numpy(), ref)
    assert (ref_bb is None) == (got_bb is None)
    if got_bb is not None:
        _close(got_bb.numpy(), ref_bb)
    # a clip that is not flipped is untouched; missing joints stay zero
    np.testing.assert_array_equal(got[1].numpy(), pose[1])
    assert (got[0, :, 7] == 0).all()


@pytest.mark.parametrize("with_bboxes", [False, True],
                         ids=["no_bboxes", "bboxes"])
def test_rotate_pose_matches_jax(with_bboxes):
    pose = _pose(3)
    bboxes = np.asarray(j_bboxes(jnp.asarray(pose[..., :2]))) \
        if with_bboxes else None
    ref, ref_bb = JA.rotate_pose(
        jnp.asarray(pose), jnp.asarray(ANGLES),
        None if bboxes is None else jnp.asarray(bboxes))
    got, got_bb = A.rotate_pose(
        torch.from_numpy(pose), torch.from_numpy(ANGLES),
        None if bboxes is None else torch.from_numpy(bboxes))
    _close(got.numpy(), ref)
    if with_bboxes:
        _close(got_bb.numpy(), ref_bb)
    assert (got[0, :, 7] == 0).all()


@pytest.mark.parametrize("with_clip_size", [False, True],
                         ids=["no_clip_size", "clip_size"])
def test_invert_matches_jax(with_clip_size):
    pose = _pose()
    clip_size = CLIP_SIZE if with_clip_size else None
    bboxes = np.asarray(j_bboxes(jnp.asarray(pose[..., :2])))
    j_aug = JA.AugmentPose(J_BODY_25, flip=0.5, rotate=10.0)
    t_aug = A.AugmentPose(BODY_25_SKELETON, flip=0.5, rotate=10.0)
    ref = j_aug.invert(jnp.asarray(pose), JA.AugmentParams(
        jnp.asarray(FLIPS), jnp.asarray(ANGLES)), jnp.asarray(bboxes),
        None if clip_size is None else jnp.asarray(clip_size))
    got = t_aug.invert(torch.from_numpy(pose), A.AugmentParams(
        torch.from_numpy(FLIPS), torch.from_numpy(ANGLES)),
        torch.from_numpy(bboxes),
        None if clip_size is None else torch.from_numpy(clip_size))
    _close(got.numpy(), ref)


# -- the random parts, by property and by distribution --------------------------
def test_augmentation_draws_flips_and_angles_at_their_rates():
    n = 4000
    pose = torch.from_numpy(_pose(Bp=1)).expand(n, -1, -1, -1).contiguous()
    aug = A.AugmentPose(BODY_25_SKELETON, flip=True, rotate=True)
    assert (aug.flip_prob, aug.max_rotation) == (0.5, 10.0)
    _, _, params = aug(torch.Generator().manual_seed(0), pose)
    rate = params.is_flipped.float().mean().item()
    assert abs(rate - 0.5) < 4 * np.sqrt(0.25 / n)
    angles = params.rotation.numpy()
    assert angles.min() >= -10.0 and angles.max() <= 10.0
    assert angles.min() < -9.9 and angles.max() > 9.9
    assert abs(angles.mean()) < 4 * 10.0 / np.sqrt(3 * n)
    # uniform: each tenth of the range holds about a tenth of the angles
    counts, _ = np.histogram(angles, bins=10, range=(-10, 10))
    assert np.all(np.abs(counts - n / 10) < 4 * np.sqrt(n / 10))
    # off: nothing drawn changes the pose
    still = A.AugmentPose(BODY_25_SKELETON, flip=0.0, rotate=0.0)
    out, _, _ = still(torch.Generator().manual_seed(0), pose[:4])
    assert torch.equal(out, pose[:4])


def test_missing_joints_are_dropped_at_their_rate():
    probs = tuple(np.linspace(0.0, 0.9, 25))
    cfg = P.PreprocessingConfig(data_nodes=BODY_25_SKELETON,
                                input_nodes=BODY_25_SKELETON,
                                transform="none",
                                missing_joint_probabilities=probs)
    raw = torch.full((400, 10, 25, 2), 50.0)
    inputs, targets = P.process_batch(torch.Generator().manual_seed(1), raw,
                                      cfg)
    dropped = (inputs == 0).all(-1).float().mean(dim=(0, 1)).numpy()
    n = 400 * 10
    tol = 4 * np.sqrt(np.asarray(probs) * (1 - np.asarray(probs)) / n) + 1e-9
    assert np.all(np.abs(dropped - np.asarray(probs)) <= tol)
    assert torch.equal(targets["projection_2d"], raw)     # truth stays clean


def _augmented_config():
    J = len(BODY_25_SKELETON)
    probs = [0.0] * J
    probs[4] = 1.0                                 # RWrist always dropped
    return P.PreprocessingConfig(
        data_nodes=BODY_25_SKELETON, input_nodes=CARLA_SKELETON,
        noise="gaussian", noise_param=3.0,
        missing_joint_probabilities=tuple(probs), augment_flip=0.5,
        augment_rotate=10.0, needs_confidence=True)


def test_random_process_batch_properties():
    cfg = _augmented_config()
    assert not P.is_deterministic(cfg, True)
    # no missing joints in the data: a flip moves a missing joint's zero to
    # its mirror's slot, which invert cannot undo (in both packages)
    raw = _pose(C=2, Bp=64, missing=False)
    bboxes = get_bboxes(torch.from_numpy(raw))
    clip_size = torch.tensor([[1920.0, 1080.0]]).expand(64, 2)
    run = functools.partial(P.process_batch, raw_projection_2d=torch.from_numpy(
        raw), cfg=cfg, training=True, bboxes=bboxes, clip_size=clip_size)
    inputs, targets = run(torch.Generator().manual_seed(3))
    again, _ = run(torch.Generator().manual_seed(3))
    other, _ = run(torch.Generator().manual_seed(4))
    assert torch.equal(inputs, again) and not torch.equal(inputs, other)
    flips = targets["is_flipped"]
    assert 0 < int(flips.sum()) < 64

    # the dropped joint (BODY_25 RWrist -> CARLA crl_hand__R) has
    # confidence 0, and the joints with no detection in BODY_25 are zeros
    hand = int(CARLA_SKELETON.crl_hand__R)
    assert (inputs[..., hand, 2] == 0).all()
    assert (targets["projection_2d_deformed"][..., hand, :] == 0).all()
    root = int(CARLA_SKELETON.crl_root)
    assert (inputs[..., root, :] == 0).all()
    deformed = targets["projection_2d_deformed"]
    present = (deformed != 0).any(-1).float()
    np.testing.assert_array_equal(inputs[..., 2].numpy(), present.numpy())

    # the clean targets carry the augmentation and none of the noise:
    # inverting the augmentation gets the raw pose back
    aug = A.AugmentPose(BODY_25_SKELETON, flip=0.5, rotate=10.0)
    params = A.AugmentParams(flips, targets["rotation"])
    gen = torch.Generator().manual_seed(3)
    augmented, aug_bb, drawn = aug(gen, torch.from_numpy(raw),
                                   bboxes=bboxes, clip_size=clip_size)
    assert torch.equal(drawn.is_flipped, flips)
    back = aug.invert(augmented, params, bboxes=aug_bb, clip_size=clip_size)
    np.testing.assert_allclose(back.numpy(), raw, rtol=0, atol=2e-3)
    _close(targets["projection_2d"].numpy(),
           P.remap_nodes(augmented, cfg).numpy())
    noise = (deformed - targets["projection_2d"])[present.bool()]
    assert 2.0 < float(noise.std()) < 4.0
