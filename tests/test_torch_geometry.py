"""Port parity: skeleton constants, rotations, kinematics, camera,
normalization and reference skeletons of ``pedestrians_video_2_carla_torch``
against the JAX package, on the same seeded numpy inputs (CPU, float32)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.ops import camera as JC
from pedestrians_video_2_carla_tpu.ops import kinematics as JK
from pedestrians_video_2_carla_tpu.ops import normalization as JN
from pedestrians_video_2_carla_tpu.ops import reference_skeletons as JRS
from pedestrians_video_2_carla_tpu.ops import rotations as JR
from pedestrians_video_2_carla_tpu.skeletons import carla as JS

from pedestrians_video_2_carla_torch.ops import camera as TC
from pedestrians_video_2_carla_torch.ops import kinematics as TK
from pedestrians_video_2_carla_torch.ops import normalization as TN
from pedestrians_video_2_carla_torch.ops import reference_skeletons as TRS
from pedestrians_video_2_carla_torch.ops import rotations as TR
from pedestrians_video_2_carla_torch.skeletons import carla as TS

from .ops.np_reference import random_rotation_matrices
from .torch_threads import limit_torch_threads

limit_torch_threads()

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "sk_female_absolute.json")
B, L = 3, 5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               atol=atol, rtol=rtol)


def _reference_batch(rng, batch=B):
    agi = rng.integers(0, 4, size=batch)
    locs, rots = TS.reference_poses_tensor()
    return locs[agi], rots[agi], agi


# -- skeleton data -----------------------------------------------------------

def test_skeleton_constants_match():
    assert TS.BONE_NAMES == JS.BONE_NAMES
    np.testing.assert_array_equal(TS.PARENTS, JS.PARENTS)
    assert len(TS.TOPO_LEVELS) == len(JS.TOPO_LEVELS) == 8
    for a, b in zip(TS.TOPO_LEVELS, JS.TOPO_LEVELS):
        np.testing.assert_array_equal(a, b)
    assert TS.AGE_GENDER_KEYS == JS.AGE_GENDER_KEYS
    assert int(TS.CARLA_SKELETON.get_hips_point()) \
        == int(JS.CARLA_SKELETON.get_hips_point())
    assert int(TS.CARLA_SKELETON.get_neck_point()) \
        == int(JS.CARLA_SKELETON.get_neck_point())
    for port, ref in zip(TS.reference_poses_tensor(),
                         JS.reference_poses_tensor()):
        np.testing.assert_array_equal(port, ref)


# -- rotations ---------------------------------------------------------------

def test_euler_angles_to_matrix(rng):
    angles = rng.uniform(-np.pi, np.pi, size=(B, L, 3)).astype(np.float32)
    _close(TR.euler_angles_to_matrix(_t(angles)),
           JR.euler_angles_to_matrix(jnp.asarray(angles)), atol=1e-6)
    np.testing.assert_array_equal(TR.euler_angles_to_matrix_np(angles),
                                  JR.euler_angles_to_matrix_np(angles))


def test_rotation_6d_roundtrip(rng):
    d6 = rng.standard_normal((B, L, 26, 6)).astype(np.float32)
    d6[0, 0, 0] = 0.0  # the degenerate input the rsqrt guard exists for
    port = TR.rotation_6d_to_matrix(_t(d6))
    # XLA's and PyTorch's rsqrt differ by a few ulp: unit vectors to 1e-5
    _close(port, JR.rotation_6d_to_matrix(jnp.asarray(d6)), atol=1e-5)
    _close(TR.matrix_to_rotation_6d(port),
           JR.matrix_to_rotation_6d(jnp.asarray(port.numpy())), atol=0)

    # gradient through the guard stays finite and equal to JAX's
    x = _t(d6).requires_grad_(True)
    TR.rotation_6d_to_matrix(x).sum().backward()
    g_ref = jax.grad(lambda v: JR.rotation_6d_to_matrix(v).sum())(
        jnp.asarray(d6))
    assert torch.isfinite(x.grad).all()
    _close(x.grad, g_ref, atol=1e-4, rtol=1e-4)


# -- kinematics --------------------------------------------------------------

def test_forward_kinematics(rng):
    locs, _, _ = _reference_batch(rng)
    rel_loc = np.broadcast_to(locs[:, None], (B, L, 26, 3)).copy()
    rel_rot = random_rotation_matrices(rng, (B, L, 26)).astype(np.float32)
    p_loc, p_rot = TK.forward_kinematics(_t(rel_loc), _t(rel_rot))
    r_loc, r_rot = JK.forward_kinematics(rel_loc, rel_rot)
    _close(p_loc, r_loc, atol=1e-5)
    _close(p_rot, r_rot, atol=1e-5)
    with pytest.raises(ValueError):
        TK.forward_kinematics(_t(rel_loc[..., :25, :]), _t(rel_rot))


def test_fk_planes(rng):
    loc = rng.standard_normal((3, B, L, 26)).astype(np.float32)
    rot = random_rotation_matrices(rng, (B, L, 26)).astype(np.float32)
    rot9 = [rot[..., i, j] for i in range(3) for j in range(3)]
    p_loc, p_rot = TK.fk_planes(tuple(_t(c) for c in loc),
                                tuple(_t(c) for c in rot9))
    r_loc, r_rot = JK.fk_planes(tuple(jnp.asarray(c) for c in loc),
                                tuple(jnp.asarray(c) for c in rot9))
    for p, r in zip(p_loc + p_rot, r_loc + r_rot):
        _close(p, r, atol=1e-5)


def test_relative_pose_over_clip(rng):
    # sequential loop (port) vs associative scan (JAX): the rounding order
    # differs, so float32 agreement to 1e-5 over an 8-frame clip
    locs, rots, _ = _reference_batch(rng)
    changes = random_rotation_matrices(rng, (B, 8, 26)).astype(np.float32)
    port = TK.relative_pose_over_clip(_t(changes), _t(locs), _t(rots))
    ref = JK.relative_pose_over_clip(changes, locs, rots)
    for p, r in zip(port, ref):
        _close(p, r, atol=1e-5)


@pytest.mark.parametrize("which", ["none", "loc", "rot", "both"])
def test_world_from_changes(rng, which):
    dl = rng.standard_normal((B, L, 3)).astype(np.float32) \
        if which in ("loc", "both") else None
    dr = random_rotation_matrices(rng, (B, L)).astype(np.float32) \
        if which in ("rot", "both") else None
    p_loc, p_rot = TK.world_from_changes(
        (B, L), None if dl is None else _t(dl), None if dr is None else _t(dr))
    r_loc, r_rot = JK.world_from_changes((B, L), dl, dr)
    _close(p_loc, r_loc, atol=1e-5)
    _close(p_rot, r_rot, atol=1e-5)


def test_fk_matches_ue4_golden_absolute_pose():
    """FK of the adult-female reference must reproduce the UE4-exported
    absolute pose, at the tolerances of tests/ops/test_kinematics.py
    (loc 1e-5 m, rotation 1e-2 deg, root ignored)."""
    rel_loc, rel_rot = TS.load_reference_pose("adult_female")
    abs_loc, abs_rot = TK.forward_kinematics(_t(rel_loc), _t(rel_rot))
    abs_loc, abs_rot = abs_loc.numpy(), abs_rot.numpy()

    with open(GOLDEN) as f:
        golden = json.load(f)
    g_loc = np.asarray([golden[n]["location"] for n in TS.BONE_NAMES]) / 100.0
    g_rot = np.asarray([golden[n]["rotation"] for n in TS.BONE_NAMES])
    g_loc = g_loc - g_loc[int(TS.CARLA_SKELETON.crl_hips__C)]

    carla_loc = abs_loc * np.asarray([1.0, 1.0, -1.0])
    # matrix -> XYZ euler -> CARLA (pitch, yaw, roll) degrees
    central = np.arcsin(np.clip(abs_rot[..., 0, 2], -1.0, 1.0))
    first = np.arctan2(-abs_rot[..., 1, 2], abs_rot[..., 2, 2])
    third = np.arctan2(-abs_rot[..., 0, 1], abs_rot[..., 0, 0])
    angles = -np.rad2deg(np.stack([first, central, third], -1))
    carla_rot = np.stack([angles[:, 1], angles[:, 2], angles[:, 0]], -1)

    for i, name in enumerate(TS.BONE_NAMES):
        if i == int(TS.CARLA_SKELETON.crl_root):
            continue
        np.testing.assert_allclose(carla_loc[i], g_loc[i], atol=1e-5,
                                   err_msg=f"location mismatch for {name}")
        diff = (carla_rot[i] - g_rot[i] + 180.0) % 360.0 - 180.0
        np.testing.assert_allclose(diff, np.zeros(3), atol=1e-2,
                                   err_msg=f"rotation mismatch for {name}")


# -- camera ------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [{}, {"distance": 3.1, "elevation": 0.0,
                                         "look_at": (0.0, 0.0, 0.0)},
                                    {"shift": 0.4, "fov_deg": 70.0}])
def test_make_camera(kwargs):
    port, ref = TC.make_camera(**kwargs), JC.make_camera(**kwargs)
    _close(port.R, ref.R, atol=1e-7)
    _close(port.T, ref.T, atol=1e-7)
    assert port.focal == ref.focal and port.principal == ref.principal
    assert port.image_size == ref.image_size


@pytest.mark.parametrize("world", [False, True])
def test_project_pose(rng, world):
    locs, _, _ = _reference_batch(rng)
    abs_loc = (np.broadcast_to(locs[:, None], (B, L, 26, 3))
               + 0.05 * rng.standard_normal((B, L, 26, 3))).astype(np.float32)
    w_loc = w_rot = None
    if world:
        w_loc = (0.2 * rng.standard_normal((B, L, 3))).astype(np.float32)
        w_rot = JR.euler_angles_to_matrix_np(
            rng.uniform(-0.3, 0.3, (B, L, 3))).astype(np.float32)
    port = TC.project_pose(TC.make_camera(), _t(abs_loc),
                           None if w_loc is None else _t(w_loc),
                           None if w_rot is None else _t(w_rot))
    ref = JC.project_pose(JC.make_camera(), abs_loc, w_loc, w_rot)
    _close(port[..., :2], ref[..., :2], atol=1e-3)   # pixels
    _close(port[..., 2], ref[..., 2], atol=1e-5)     # metres


# -- normalization and reference skeletons -----------------------------------

@pytest.mark.parametrize("extractor", ["hips_neck", "bbox"])
def test_normalize_with(rng, extractor):
    pts = rng.uniform(1.0, 600.0, size=(B, L, 26, 2)).astype(np.float32)
    pts[0, 0, 5] = 0.0  # a missing joint
    pts[1, 2] = 0.0     # a fully missing frame: degenerate scale
    port, p_ss = TN.normalize_with(_t(pts), TS.CARLA_SKELETON,
                                   extractor=extractor)
    ref, r_ss = JN.normalize_with(jnp.asarray(pts), JS.CARLA_SKELETON,
                                  extractor=extractor)
    _close(port, ref, atol=1e-5)
    _close(p_ss.shift, r_ss.shift, atol=1e-4)
    _close(p_ss.scale, r_ss.scale, atol=1e-4, rtol=1e-6)
    _close(TN.denormalize(port, p_ss), JN.denormalize(ref, r_ss), atol=1e-3)


def test_safe_norm_gradient_at_zero():
    v = torch.zeros((2, 3), requires_grad=True)
    TN._safe_norm(v).sum().backward()
    g_ref = jax.grad(lambda x: JN._safe_norm(x).sum())(jnp.zeros((2, 3)))
    assert torch.isfinite(v.grad).all()
    _close(v.grad, g_ref, atol=0)


def test_reference_skeletons(rng):
    for port, ref in zip(TRS.reference_absolute_tensors(),
                         JRS.reference_absolute_tensors()):
        _close(port, ref, atol=1e-6)
    frames = rng.standard_normal((B, L, 26, 3)).astype(np.float32)
    agi = rng.integers(0, 4, size=B)
    _close(TRS.denormalize_from_abs(_t(frames), _t(agi), autonormalize=True),
           JRS.denormalize_from_abs(frames, agi, autonormalize=True),
           atol=1e-5)
