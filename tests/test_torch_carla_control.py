"""The port's CARLA control against the JAX package's, on the CPU: the
rotation conversions and ``move``, the float64 CARLA rotation algebra,
the CARLA-dict ``Pose`` for all four reference poses, the unbound
``ControlledPedestrian``, ``PoseProjection`` in both camera forms, the
CARLA renderer under the mock and under a fake simulator, the writer's
``carla`` and ``source_carla`` clips, and the gym environment with its
three wrappers.

Tolerances: float32 tensor functions within 1e-6 (matrices) and 1e-4
degrees (angles, which ``atan2`` / ``asin`` of float32 put there); the
float64 algebra and the pose dicts within 1e-9; projections within 1e-3
px; frames and clips bit for bit.

The fake simulator is one test double (``FakeCarla``) bound into both
packages: the port reads its binding as ``carla_utils.carla`` at call
time, so one assignment switches it; each of the JAX package's modules
imported ``carla`` by name, so each is patched.
"""
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.gym_carla_pedestrians import \
    envs as JEnvs
from pedestrians_video_2_carla_tpu.gym_carla_pedestrians import \
    wrappers as JWrappers
from pedestrians_video_2_carla_tpu.loggers import \
    pedestrian_writer as JWriter
from pedestrians_video_2_carla_tpu.ops import kinematics as JK
from pedestrians_video_2_carla_tpu.ops import rotations as JR
from pedestrians_video_2_carla_tpu.renderers import carla_renderer as JRend
from pedestrians_video_2_carla_tpu.walker_control import \
    carla_utils as JCU
from pedestrians_video_2_carla_tpu.walker_control import \
    controlled_pedestrian as JCP
from pedestrians_video_2_carla_tpu.walker_control import pose as JPose
from pedestrians_video_2_carla_tpu.walker_control import \
    pose_projection as JPP
from pedestrians_video_2_carla_tpu.skeletons.carla import \
    load_reference_pose as j_load_reference_pose

from pedestrians_video_2_carla_torch.gym_carla_pedestrians import \
    envs as TEnvs
from pedestrians_video_2_carla_torch.gym_carla_pedestrians import \
    wrappers as TWrappers
from pedestrians_video_2_carla_torch.loggers import \
    pedestrian_writer as TWriter
from pedestrians_video_2_carla_torch.ops import kinematics as TK
from pedestrians_video_2_carla_torch.ops import rotations as TR
from pedestrians_video_2_carla_torch.renderers import carla_renderer as TRend
from pedestrians_video_2_carla_torch.skeletons.carla import (
    AGE_GENDER_KEYS, BONE_NAMES, reference_pose_key)
from pedestrians_video_2_carla_torch.walker_control import \
    carla_utils as TCU
from pedestrians_video_2_carla_torch.walker_control import \
    controlled_pedestrian as TCP
from pedestrians_video_2_carla_torch.walker_control import pose as TPose
from pedestrians_video_2_carla_torch.walker_control import \
    pose_projection as TPP
from .torch_threads import limit_torch_threads

limit_torch_threads()

MAT_TOL, DEG_TOL, F64_TOL, PX_TOL = 1e-6, 1e-4, 1e-9, 1e-3


def _rotations(rng, shape, max_deg=170.0):
    """Seeded rotation matrices (float32) from euler angles."""
    angles = np.deg2rad(rng.uniform(-max_deg, max_deg, shape + (3,)))
    angles[..., 1] /= 2.0  # away from the XYZ convention's gimbal lock
    return TR.euler_angles_to_matrix_np(angles, "XYZ").astype(np.float32)


def _deg_close(got, want, tol, msg=""):
    diff = (np.asarray(got, np.float64) - np.asarray(want, np.float64)
            + 180.0) % 360.0 - 180.0
    np.testing.assert_allclose(diff, 0.0, atol=tol, err_msg=msg)


def _xyz(loc):
    return [loc.x, loc.y, loc.z]


def _pyr(rot):
    return [rot.pitch, rot.yaw, rot.roll]


def _pose_close(got: OrderedDict, want: OrderedDict, tol=F64_TOL):
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_allclose(_xyz(got[name].location),
                                   _xyz(want[name].location), atol=tol,
                                   err_msg=name)
        _deg_close(_pyr(got[name].rotation), _pyr(want[name].rotation), tol,
                   name)


# -- ops ---------------------------------------------------------------------

def test_rotation_conversions_and_move_match_jax(rng):
    mats = _rotations(rng, (5, 26))
    t = torch.from_numpy(mats)
    np.testing.assert_allclose(
        TR.matrix_to_euler_angles(t).numpy(),
        np.asarray(JR.matrix_to_euler_angles(jnp.asarray(mats))),
        atol=1e-6)
    pyr = TR.matrix_to_carla_rotation(t).numpy()
    _deg_close(pyr, np.asarray(JR.matrix_to_carla_rotation(
        jnp.asarray(mats))), DEG_TOL)
    degrees = rng.uniform(-170, 170, (5, 26, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TR.carla_rotation_to_matrix(torch.from_numpy(degrees)).numpy(),
        np.asarray(JR.carla_rotation_to_matrix(jnp.asarray(degrees))),
        atol=MAT_TOL)
    # the round trip gives the matrices back
    np.testing.assert_allclose(
        TR.carla_rotation_to_matrix(torch.from_numpy(pyr)).numpy(), mats,
        atol=1e-5)
    xyz = rng.standard_normal((5, 26, 3)).astype(np.float32)
    for t_fn, j_fn in ((TR.carla_location_to_p3d, JR.carla_location_to_p3d),
                       (TR.p3d_location_to_carla, JR.p3d_location_to_carla)):
        np.testing.assert_array_equal(
            t_fn(torch.from_numpy(xyz)).numpy(),
            np.asarray(j_fn(jnp.asarray(xyz))))
    eye = TR.eye_batch((2, 4), dtype=torch.float64)
    assert eye.dtype == torch.float64
    np.testing.assert_array_equal(eye.numpy(),
                                  np.asarray(JR.eye_batch((2, 4))))
    changes = _rotations(rng, (5, 26), 20.0)
    np.testing.assert_allclose(
        TK.move(torch.from_numpy(changes), t).numpy(),
        np.asarray(JK.move(jnp.asarray(changes), jnp.asarray(mats))),
        atol=MAT_TOL)
    assert reference_pose_key("child", "male") == "child_male"


def test_carla_rotation_algebra_matches_jax(rng):
    for _ in range(20):
        a, b = (TCU.carla.Rotation(*rng.uniform(-170, 170, 3).tolist())
                for _ in range(2))
        ja, jb = (JCU.carla.Rotation(r.pitch, r.yaw, r.roll) for r in (a, b))
        np.testing.assert_allclose(TCU.carla_rotation_matrix(a),
                                   JCU.carla_rotation_matrix(ja),
                                   atol=F64_TOL)
        m = _rotations(rng, ()).astype(np.float64)
        _deg_close(_pyr(TCU.matrix_to_carla_rotation(m)),
                   _pyr(JCU.matrix_to_carla_rotation(m)), F64_TOL)
        _deg_close(_pyr(TCU.mul_carla_rotations(a, b)),
                   _pyr(JCU.mul_carla_rotations(ja, jb)), F64_TOL)
        loc = rng.standard_normal(3).tolist()
        t = TCU.carla.Transform(TCU.carla.Location(*loc), a)
        jt = JCU.carla.Transform(JCU.carla.Location(*loc), ja)
        np.testing.assert_allclose(
            _xyz(TCU.transform_location(t, TCU.carla.Location(*loc))),
            _xyz(JCU.transform_location(jt, JCU.carla.Location(*loc))),
            atol=F64_TOL)
    assert TCU.using_mock_carla() and TCU.carla is TCU.mock_carla
    with pytest.raises(RuntimeError, match="mock carla"):
        TCU.setup_client_and_world()


# -- Pose, ControlledPedestrian ---------------------------------------------

def _changes(module, rng, bones):
    return {name: module.carla.Rotation(*v) for name, v in zip(
        bones, rng.uniform(-30, 30, (len(bones), 3)).tolist())}


@pytest.mark.parametrize("key", AGE_GENDER_KEYS)
def test_pose_matches_jax(key):
    age, gender = key.split("_")
    rng = np.random.default_rng(AGE_GENDER_KEYS.index(key))
    got, root_hips = TPose.load_reference_pose_dict(age, gender)
    want, j_root_hips = JPose.load_reference_pose_dict(age, gender)
    _pose_close(got, want)
    _pose_close({"t": root_hips}, {"t": j_root_hips})
    pose, j_pose = TPose.Pose(), JPose.Pose()
    pose.relative, j_pose.relative = got, want
    _pose_close(pose.absolute, j_pose.absolute)
    for _ in range(3):
        bones = list(rng.choice(BONE_NAMES, 5, replace=False))
        seed = int(rng.integers(1 << 31))
        pose.move(_changes(TCU, np.random.default_rng(seed), bones))
        j_pose.move(_changes(JCU, np.random.default_rng(seed), bones))
        _pose_close(pose.relative, j_pose.relative)
        _pose_close(pose.absolute, j_pose.absolute)
        for a, b in zip(pose.tensors(), j_pose.tensors()):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=MAT_TOL)
    # the FK of the tensors equals the dict's absolute pose
    loc, rot = pose.tensors()
    abs_loc, _ = JK.forward_kinematics(loc, rot)
    np.testing.assert_allclose(
        [_xyz(t.location) for t in pose.absolute.values()],
        np.asarray(JR.p3d_location_to_carla(abs_loc)), atol=1e-5)


def test_unbound_controlled_pedestrian_matches_jax(rng):
    ped = TCP.ControlledPedestrian(None, "child", "female")
    j_ped = JCP.ControlledPedestrian(None, "child", "female")
    assert ped.walker is None and (ped.age, ped.gender) == ("child",
                                                            "female")
    for _ in range(3):
        seed = int(rng.integers(1 << 31))
        bones = ["crl_arm__L", "crl_thigh__R", "crl_Head__C"]
        assert ped.update_pose(_changes(
            TCU, np.random.default_rng(seed), bones)) == 0
        j_ped.update_pose(_changes(JCU, np.random.default_rng(seed), bones))
        loc, rot = rng.uniform(-1, 1, 3).tolist(), \
            rng.uniform(-30, 30, 3).tolist()
        for p, cu in ((ped, TCU), (j_ped, JCU)):
            assert p.teleport_by(cu.carla.Transform(
                cu.carla.Location(*loc), cu.carla.Rotation(*rot)),
                cue_tick=True) == 0
        _pose_close(ped.current_pose.absolute, j_ped.current_pose.absolute)
        _pose_close(
            {k: getattr(ped, k) for k in ("transform", "world_transform",
                                          "initial_transform",
                                          "root_hips_transform")},
            {k: getattr(j_ped, k) for k in ("transform", "world_transform",
                                            "initial_transform",
                                            "root_hips_transform")})
        np.testing.assert_allclose(_xyz(ped.spawn_shift),
                                   _xyz(j_ped.spawn_shift), atol=F64_TOL)
    # from the initial transform, and a pose to start from
    ped.teleport_by(TCU.carla.Transform(TCU.carla.Location(x=2.0)),
                    from_initial=True)
    assert ped.transform.location.x == pytest.approx(2.0)
    other = TCP.ControlledPedestrian(None, reference_pose=ped.current_pose)
    _pose_close(other.current_pose.relative, ped.current_pose.relative)
    with pytest.raises(RuntimeError, match="real CARLA"):
        ped.bind(object())


# -- PoseProjection ----------------------------------------------------------

@pytest.mark.parametrize("form", ["rgb_camera", "position_look_at"])
def test_pose_projection_matches_jax(form, rng):
    kwargs = {} if form == "rgb_camera" else {
        "camera_position": (4.0, 0.5, 1.5), "look_at": (0.0, 0.2, 0.9)}
    ped = TCP.ControlledPedestrian(None, "adult", "male")
    j_ped = JCP.ControlledPedestrian(None, "adult", "male")
    proj = TPP.PoseProjection(ped, device="cpu", **kwargs)
    j_proj = JPP.PoseProjection(j_ped, **kwargs)
    assert proj.image_size == j_proj.image_size
    for field in ("R", "T", "focal", "principal"):
        np.testing.assert_allclose(
            np.asarray(getattr(proj.camera, field)),
            np.asarray(getattr(j_proj.camera, field)), atol=1e-6)
    abs_loc = rng.standard_normal((3, 26, 3)).astype(np.float32) * 0.5
    world_loc = rng.standard_normal((3, 3)).astype(np.float32) * 0.3
    world_rot = _rotations(rng, (3,), 40.0)
    for args in ((abs_loc,), (abs_loc, world_loc, world_rot)):
        got = proj.project(*args)
        assert got.shape == (3, 26, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, j_proj.project(*args), atol=PX_TOL)
    seed = int(rng.integers(1 << 31))
    ped.update_pose(_changes(TCU, np.random.default_rng(seed), BONE_NAMES))
    j_ped.update_pose(_changes(JCU, np.random.default_rng(seed), BONE_NAMES))
    for p, cu in ((ped, TCU), (j_ped, JCU)):
        p.teleport_by(cu.carla.Transform(cu.carla.Location(0.3, -0.2, 0.0),
                                         cu.carla.Rotation(yaw=35.0)))
    pts = proj.current_pose_to_points()
    assert pts.shape == (26, 2)
    np.testing.assert_allclose(pts, np.asarray(
        j_proj.current_pose_to_points()), atol=PX_TOL)
    mock = TPP.RGBCameraMock(x=320, y=240)
    assert TPP.PoseProjection(camera_rgb=mock, device="cpu").image_size \
        == (320, 240)


@pytest.mark.parametrize("key", ["adult_female", "child_male"])
def test_carla_route_agrees_with_the_tensor_route(key, rng):
    """A relative pose as the CARLA path applies it (the matrices as CARLA
    rotations on the pedestrian, its world transform teleported) projects
    where FK and the camera put the tensors, in both packages: the bar the
    card's CARLA phase holds."""
    from pedestrians_video_2_carla_tpu.ops import camera as JC

    from pedestrians_video_2_carla_torch.ops import camera as TC
    from pedestrians_video_2_carla_torch.ops.kinematics import \
        forward_kinematics
    from pedestrians_video_2_carla_torch.skeletons.carla import \
        load_reference_pose

    age, gender = key.split("_")
    rel_loc, rel_rot = load_reference_pose(key)
    for _ in range(3):
        rot = np.einsum("jab,jbc->jac", _rotations(rng, (26,), 20.0),
                        rel_rot).astype(np.float32)
        wloc = (rng.uniform(-1, 1, 3) * [1, 1, 0.1]).astype(np.float32)
        wpyr = [0.0, float(rng.uniform(-180, 180)), 0.0]
        wrot = TR.carla_rotation_to_matrix(torch.tensor(wpyr)).numpy()
        abs_loc, _ = forward_kinematics(torch.from_numpy(rel_loc),
                                        torch.from_numpy(rot))
        tensor_route = TC.project_pose(
            TC.make_camera(), abs_loc[None], torch.from_numpy(wloc)[None],
            torch.from_numpy(wrot)[None])[0, :, :2].numpy()
        j_abs, _ = JK.forward_kinematics(j_load_reference_pose(key)[0], rot)
        j_tensor_route = np.asarray(JC.project_pose(
            JC.make_camera(), j_abs[None], jnp.asarray(wloc)[None],
            jnp.asarray(wrot)[None]))[0, :, :2]
        for cu, cp, pp, pyr, tensor in (
                (TCU, TCP, TPP, TRend.carla_rotations(rot), tensor_route),
                (JCU, JCP, JPP, np.asarray(JR.matrix_to_carla_rotation(
                    jnp.asarray(rot))), j_tensor_route)):
            ped = cp.ControlledPedestrian(None, age, gender)
            proj = pp.PoseProjection(ped, **({"device": "cpu"}
                                             if pp is TPP else {}))
            pose = ped.current_pose.relative
            for j, name in enumerate(BONE_NAMES):
                pose[name].rotation = cu.carla.Rotation(*pyr[j].tolist())
            ped.current_pose.relative = pose
            ped.teleport_by(cu.carla.Transform(
                cu.carla.Location(float(wloc[0]), float(wloc[1]),
                                  float(-wloc[2])),
                cu.carla.Rotation(*wpyr)))
            np.testing.assert_allclose(proj.current_pose_to_points(), tensor,
                                       atol=PX_TOL)


# -- the CARLA renderer ------------------------------------------------------

class FakeCarla:
    """A test double of the carla package: the mock's types, a bone
    control, and a client whose world records what is done to it."""

    class Location:
        def __init__(self, x=0.0, y=0.0, z=0.0):
            self.x, self.y, self.z = float(x), float(y), float(z)

    class Rotation:
        def __init__(self, pitch=0.0, yaw=0.0, roll=0.0):
            self.pitch, self.yaw, self.roll = (float(pitch), float(yaw),
                                               float(roll))

    class Transform:
        def __init__(self, location=None, rotation=None):
            self.location = location or FakeCarla.Location()
            self.rotation = rotation or FakeCarla.Rotation()

    class WalkerBoneControlIn:
        bone_transforms = None

    class WorldSettings:
        def __init__(self, **kwargs):
            self.__dict__.update(kwargs)

    class World:
        pass

    def __init__(self, seed):
        self.world = FakeWorld(self, seed)

    def Client(self, host, port):
        carla = self

        class _Client:
            def set_timeout(self, t):
                pass

            def get_world(self):
                return carla.world

            def get_trafficmanager(self):
                return type("TM", (), {"set_synchronous_mode":
                                       lambda self, on: None})()
        return _Client()


class _Blueprint:
    def __init__(self, attributes):
        self.attributes = dict(attributes)

    def get_attribute(self, name):
        return self.attributes.get(name)

    def has_attribute(self, name):
        return name in self.attributes

    def set_attribute(self, name, value):
        self.attributes[name] = value


class FakeWorld:
    """Records set_bones, set_transform and tick; each tick gives every
    listening camera a seeded BGRA frame of its blueprint's size."""

    def __init__(self, carla, seed):
        self.carla = carla
        self.rng = np.random.default_rng(seed)
        self.log = []
        self.cameras = []
        self.settings = carla.WorldSettings()

    def apply_settings(self, settings):
        self.settings = settings

    def get_settings(self):
        return self.settings

    def tick(self):
        self.log.append(("tick",))
        for camera in self.cameras:
            if camera.callback is not None:
                w, h = (int(camera.bp.get_attribute(k))
                        for k in ("image_size_x", "image_size_y"))
                camera.callback(type("Image", (), {
                    "width": w, "height": h, "raw_data": self.rng.integers(
                        0, 256, (h, w, 4), dtype=np.uint8).tobytes()})())
        return len(self.log)

    def get_blueprint_library(self):
        world = self

        class _Library:
            def filter(self, pattern):
                return [_Blueprint({"age": a, "gender": g,
                                    "is_invincible": "true"})
                        for a in ("adult", "child")
                        for g in ("female", "male")]

            def find(self, name):
                return _Blueprint({"name": name})
        world.library = _Library()
        return world.library

    def get_random_location_from_navigation(self):
        return self.carla.Location(*self.rng.uniform(-50, 50, 3).tolist())

    def try_spawn_actor(self, bp, transform):
        return FakeWalker(self, transform)

    def spawn_actor(self, bp, transform):
        camera = FakeCamera(bp, transform)
        self.cameras.append(camera)
        return camera


class FakeWalker:
    def __init__(self, world, transform):
        self.world, self._transform = world, transform

    def get_transform(self):
        return self._transform

    def set_transform(self, t):
        self._transform = t
        self.world.log.append(("set_transform", *_xyz(t.location),
                               *_pyr(t.rotation)))

    def set_simulate_physics(self, enabled=True):
        pass

    def set_bones(self, control):
        self.world.log.append(("set_bones", [
            (name, *_xyz(t.location), *_pyr(t.rotation))
            for name, t in control.bone_transforms]))

    def blend_pose(self, blend):
        pass

    def destroy(self):
        self.world.log.append(("walker_destroyed",))


class FakeCamera:
    def __init__(self, bp, transform):
        self.bp, self.transform, self.callback = bp, transform, None

    def listen(self, callback):
        self.callback = callback

    def stop(self):
        self.callback = None

    def destroy(self):
        pass


JAX_CARLA_MODULES = (JCU, JPose, JCP, JPP, JRend, JEnvs)


@pytest.fixture
def fake_simulators(monkeypatch):
    """One FakeCarla bound into the port and one into the JAX package, with
    the same seed."""
    port, jax_side = FakeCarla(5), FakeCarla(5)
    monkeypatch.setattr(TCU, "carla", port)
    for module in JAX_CARLA_MODULES:
        monkeypatch.setattr(module, "carla", jax_side)
    monkeypatch.setattr(JCU, "_USING_MOCK", False)
    return port, jax_side


def _log_close(got, want):
    assert [e[0] for e in got] == [e[0] for e in want]
    for a, b in zip(got, want):
        if a[0] == "set_bones":
            assert [r[0] for r in a[1]] == [r[0] for r in b[1]]
            np.testing.assert_allclose(
                [r[1:4] for r in a[1]], [r[1:4] for r in b[1]], atol=F64_TOL)
            _deg_close([r[4:] for r in a[1]], [r[4:] for r in b[1]], DEG_TOL)
        elif a[0] == "set_transform":
            np.testing.assert_allclose(a[1:], b[1:], atol=1e-6)


def _clips(rng, batch=2, length=3):
    rot = np.stack([_rotations(rng, (length, 26), 60.0)
                    for _ in range(batch)])
    world_loc = rng.standard_normal((batch, length, 3)).astype(np.float32)
    return rot, world_loc


def test_carla_renderer_under_the_mock_matches_jax(rng):
    rot, world_loc = _clips(rng)
    got = list(TRend.CarlaRenderer(image_size=(40, 30)).render(
        relative_pose_rot=torch.from_numpy(rot),
        world_loc=torch.from_numpy(world_loc)))
    want = list(JRend.CarlaRenderer(image_size=(40, 30)).render(
        relative_pose_rot=rot, world_loc=world_loc))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.shape == (3, 30, 40, 3) and not a.any()
        np.testing.assert_array_equal(a, b)


def test_carla_renderer_under_a_fake_simulator_matches_jax(fake_simulators,
                                                           rng):
    port, jax_side = fake_simulators
    assert TCU.using_mock_carla() is False and JCU.using_mock_carla() is False
    rot, world_loc = _clips(rng)
    meta = {"age": np.asarray(["adult", "child"]),
            "gender": np.asarray(["male", "female"])}
    loc = rng.standard_normal(rot.shape[:-1]).astype(np.float32)
    got = list(TRend.CarlaRenderer(image_size=(40, 30)).render(
        relative_pose_loc=torch.from_numpy(loc),
        relative_pose_rot=torch.from_numpy(rot),
        world_loc=torch.from_numpy(world_loc), meta=meta))
    want = list(JRend.CarlaRenderer(image_size=(40, 30)).render(
        relative_pose_loc=loc, relative_pose_rot=rot, world_loc=world_loc,
        meta=meta))
    for a, b in zip(got, want):
        assert a.shape == (3, 30, 40, 3) and a.any()
        np.testing.assert_array_equal(a, b)
    _log_close(port.world.log, jax_side.world.log)
    bones = [e for e in port.world.log if e[0] == "set_bones"]
    # each clip: the bind's pose, then one a frame
    assert len(bones) == 2 * (1 + 3)
    assert port.world.settings.synchronous_mode is False
    # the bones of a frame are the clip's rotations, the hips and root
    # overridden by the root<->hips transform
    frame = dict((r[0], r[4:]) for r in bones[1][1])
    want_pyr = TR.matrix_to_carla_rotation(torch.from_numpy(rot[0, 0]))
    _deg_close(frame["crl_arm__L"],
               want_pyr[BONE_NAMES.index("crl_arm__L")], DEG_TOL)
    # render_clip: one clip on the world alone
    port.world.log.clear()
    jax_side.world.log.clear()
    clip = TRend.CarlaRenderer(image_size=(40, 30)).render_clip(
        port.world, None, torch.from_numpy(rot[1]), world_loc[1], None,
        "adult", "female")
    j_clip = JRend.CarlaRenderer(image_size=(40, 30)).render_clip(
        jax_side.world, None, rot[1], world_loc[1], None, "adult", "female")
    np.testing.assert_array_equal(clip, j_clip)
    _log_close(port.world.log, jax_side.world.log)


# -- the writer --------------------------------------------------------------

def _writer_batch(rng, with_rot=True, batch=2, length=3):
    inputs = rng.uniform(-1, 1, (batch, length, 26, 2)).astype(np.float32)
    targets = {"projection_2d": rng.uniform(100, 500, (batch, length, 26, 2)
                                            ).astype(np.float32),
               "relative_pose_loc": rng.standard_normal(
                   (batch, length, 26, 3)).astype(np.float32)}
    projections = {"projection_2d": rng.uniform(
        100, 500, (batch, length, 26, 2)).astype(np.float32)}
    if with_rot:
        targets["relative_pose_rot"], targets["world_loc"] = _clips(
            rng, batch, length)
        projections["relative_pose_rot"], _ = _clips(rng, batch, length)
    meta = {"age_gender_idx": np.asarray([0, 3], np.int32)[:batch]}
    return inputs, targets, projections, meta


@pytest.mark.parametrize("with_rot", [True, False],
                         ids=["relative_pose_rot", "points_fallback"])
def test_writer_carla_clips_match_jax(with_rot, tmp_path, rng):
    batch = _writer_batch(rng, with_rot)
    clips = {}
    for side, module in (("port", TWriter), ("jax", JWriter)):
        seen = clips[side] = []
        writer = module.PedestrianWriter(
            str(tmp_path / side), renderers=["source_carla", "carla"],
            max_videos=2)
        paths = writer.log_videos(*batch, stage="val", force=True,
                                  vid_callback=lambda v, *a: seen.append(v))
        assert len(paths) == 2
    for got, want in zip(clips["port"], clips["jax"]):
        np.testing.assert_array_equal(got, want)
        # black under the mock, points where a rotation is missing
        assert bool(got.any()) is not with_rot
    assert len(clips["port"]) == 2


def test_writer_raises_a_renderer_fault_instead_of_drawing_points(
        monkeypatch, tmp_path, rng):
    """The port checks for the missing key instead of catching: an error in
    the renderer (a CUDA error, say) reaches the caller."""
    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(TRend, "carla_rotations", broken)
    monkeypatch.setattr(TCU, "carla", FakeCarla(0))
    writer = TWriter.PedestrianWriter(str(tmp_path), renderers=["carla"])
    with pytest.raises(RuntimeError, match="illegal memory"):
        writer.log_videos(*_writer_batch(rng), force=True)


# -- the gym environment -----------------------------------------------------

def _obs_close(got, want):
    assert list(got) == list(want)
    for kind in ("relative_pose", "absolute_pose"):
        assert list(got[kind]) == list(want[kind]) == BONE_NAMES
        for bone in BONE_NAMES:
            np.testing.assert_allclose(got[kind][bone]["location"],
                                       want[kind][bone]["location"],
                                       atol=1e-6)
            _deg_close(got[kind][bone]["rotation"],
                       want[kind][bone]["rotation"], DEG_TOL)
    np.testing.assert_allclose(got["pose_projection"],
                               want["pose_projection"], atol=PX_TOL)


def test_gym_env_and_wrappers_match_jax():
    pytest.importorskip("gymnasium")
    env = TEnvs.CarlaPedestriansEnv(device="cpu")
    j_env = JEnvs.CarlaPedestriansEnv()
    options = {"length": 3, "age": "child", "gender": "male"}
    obs, info = env.reset(seed=3, options=options)
    j_obs, _ = j_env.reset(seed=3, options=options)
    assert info == {}
    _obs_close(obs, j_obs)
    assert env.observation_space.contains(obs) \
        == j_env.observation_space.contains(j_obs)
    env.action_space.seed(11)
    j_env.action_space.seed(11)
    for step in range(3):
        action = env.action_space.sample()
        j_action = j_env.action_space.sample()
        np.testing.assert_array_equal(action["teleport_by"]["location"],
                                      j_action["teleport_by"]["location"])
        obs, reward, terminated, truncated, info = env.step(action)
        j_obs, j_reward, j_terminated, _, _ = j_env.step(j_action)
        _obs_close(obs, j_obs)
        assert (reward, terminated, truncated) == (j_reward, j_terminated,
                                                   False)
        assert info["pedestrian"] is env.pedestrian
    assert terminated

    # the flat-array action, the blank render and the overlay on top of it
    rng = np.random.default_rng(4)
    wrapped = TWrappers.PoseOverlayRenderWrapper(TWrappers.CarlaRenderWrapper(
        TWrappers.NumpyToDictActionWrapper(
            TEnvs.CarlaPedestriansEnv(device="cpu"))))
    j_wrapped = JWrappers.PoseOverlayRenderWrapper(
        JWrappers.CarlaRenderWrapper(JWrappers.NumpyToDictActionWrapper(
            JEnvs.CarlaPedestriansEnv())))
    assert "rgb_array" in wrapped.env.metadata["render_modes"]
    for w in (wrapped, j_wrapped):
        w.reset(seed=1, options={"length": 2})
    np.testing.assert_array_equal(wrapped.render(), j_wrapped.render())
    for _ in range(2):
        action = rng.uniform(-5, 5, (28, 3)).astype(np.float32)
        action[0] *= 0.02  # a teleport of centimetres keeps it in view
        np.testing.assert_array_equal(
            wrapped.unwrapped.action_space["teleport_by"]["rotation"].shape,
            (1,))
        got = wrapped.step(action)
        want = j_wrapped.step(action)
        _obs_close(got[0], want[0])
        assert got[1:3] == want[1:3]
        frame, j_frame = wrapped.render(), j_wrapped.render()
        assert frame.shape == (600, 800, 3) and frame.any()
        np.testing.assert_array_equal(frame, j_frame)
    wrapped.close()
    j_wrapped.close()
