"""The ``carla`` binding, a mock of the few CARLA types the numerical code
touches, the CARLA-convention rotation algebra in float64 numpy, and the
helpers that set up and tear down a live CARLA world.

The real ``carla`` package is optional: the simulator is an external
process on the host. Where it is not installed, ``carla`` is the mock,
and everything numerical works on the mock's types. The other modules of
the port read the binding as ``carla_utils.carla`` when they run, so that
assigning this one name (to a simulator's client package, or a test
double) switches all of them.
"""
from queue import Queue
from typing import Tuple

import numpy as np

from ..ops.rotations import euler_angles_to_matrix_np


class _MockModule:
    """A namespace with the subset of the carla package that the
    numerical path touches."""

    class Location:
        def __init__(self, x: float = 0.0, y: float = 0.0, z: float = 0.0):
            self.x, self.y, self.z = float(x), float(y), float(z)

        def __repr__(self):
            return f"Location(x={self.x}, y={self.y}, z={self.z})"

    class Rotation:
        def __init__(self, pitch: float = 0.0, yaw: float = 0.0,
                     roll: float = 0.0):
            self.pitch, self.yaw, self.roll = (float(pitch), float(yaw),
                                               float(roll))

        def __repr__(self):
            return (f"Rotation(pitch={self.pitch}, yaw={self.yaw}, "
                    f"roll={self.roll})")

    class Transform:
        def __init__(self, location=None, rotation=None):
            self.location = location if location is not None \
                else _MockModule.Location()
            self.rotation = rotation if rotation is not None \
                else _MockModule.Rotation()

        def __repr__(self):
            return f"Transform({self.location}, {self.rotation})"


mock_carla = _MockModule()

try:
    import carla  # type: ignore
except ImportError:
    carla = mock_carla


def using_mock_carla() -> bool:
    """Whether ``carla`` is the mock (no simulator can be reached)."""
    return carla is mock_carla


def deepcopy_location(loc):
    return carla.Location(x=loc.x, y=loc.y, z=loc.z)


def deepcopy_rotation(rot):
    return carla.Rotation(pitch=rot.pitch, yaw=rot.yaw, roll=rot.roll)


def deepcopy_transform(t):
    return carla.Transform(location=deepcopy_location(t.location),
                           rotation=deepcopy_rotation(t.rotation))


# ---------------------------------------------------------------------------
# CARLA-convention rotation algebra, through the P3D row-matrix convention:
# convert, compose, convert back (float64 numpy on the host)
# ---------------------------------------------------------------------------

def _pyr(rot) -> np.ndarray:
    return np.asarray([rot.pitch, rot.yaw, rot.roll], dtype=np.float64)


def carla_rotation_matrix(rot) -> np.ndarray:
    """Row-vector P3D-convention matrix of a carla.Rotation."""
    pyr = _pyr(rot)
    angles = np.deg2rad(np.asarray([-pyr[2], -pyr[0], -pyr[1]]))
    return euler_angles_to_matrix_np(angles, "XYZ")


def matrix_to_carla_rotation(matrix: np.ndarray):
    m = np.asarray(matrix)
    central = np.arcsin(np.clip(m[..., 0, 2], -1, 1))
    first = np.arctan2(-m[..., 1, 2], m[..., 2, 2])
    third = np.arctan2(-m[..., 0, 1], m[..., 0, 0])
    roll, pitch, yaw = (-np.rad2deg(first), -np.rad2deg(central),
                        -np.rad2deg(third))
    return carla.Rotation(pitch=float(pitch), yaw=float(yaw),
                          roll=float(roll))


def mul_carla_rotations(parent_rot, child_rot):
    """CARLA rotations composed: the child applied in the parent's frame."""
    m = carla_rotation_matrix(child_rot) @ carla_rotation_matrix(parent_rot)
    return matrix_to_carla_rotation(m)


def transform_location(transform, location):
    """``carla.Transform.transform``: a location rotated, then
    translated."""
    v = np.asarray([location.x, location.y, -location.z], dtype=np.float64)
    out = v @ carla_rotation_matrix(transform.rotation)
    return carla.Location(x=float(out[0] + transform.location.x),
                          y=float(out[1] + transform.location.y),
                          z=float(-out[2] + transform.location.z))


# ---------------------------------------------------------------------------
# a live server
# ---------------------------------------------------------------------------

def setup_client_and_world(fps: float = 30.0, host: str = "server",
                           port: int = 2000):
    if using_mock_carla() or getattr(carla, "World", None) is None:
        raise RuntimeError(
            "You are using mock carla, calls to setup_client_and_world "
            "are not allowed!")
    client = carla.Client(host, port)
    client.set_timeout(10.0)
    world = client.get_world()
    world.apply_settings(carla.WorldSettings(
        synchronous_mode=True, fixed_delta_seconds=1.0 / fps,
        deterministic_ragdolls=False))
    client.get_trafficmanager().set_synchronous_mode(True)
    world.tick()
    return client, world


def get_camera_transform(pedestrian, distance: float = 3.1,
                         elevation: float = 1.2):
    t = pedestrian.world_transform
    shift = pedestrian.spawn_shift
    return carla.Transform(
        carla.Location(x=t.location.x - shift.x + distance,
                       y=t.location.y - shift.y,
                       z=t.location.z - shift.z + elevation),
        carla.Rotation(pitch=t.rotation.pitch, yaw=t.rotation.yaw - 180,
                       roll=t.rotation.roll))


def setup_camera(world, sensor_queue: Queue, pedestrian,
                 image_size: Tuple[int, int] = (800, 600), fov: float = 90.0):
    blueprint_library = world.get_blueprint_library()
    camera_bp = blueprint_library.find("sensor.camera.rgb")
    camera_bp.set_attribute("image_size_x", str(image_size[0]))
    camera_bp.set_attribute("image_size_y", str(image_size[1]))
    camera_bp.set_attribute("fov", str(fov))
    camera_rgb = world.spawn_actor(camera_bp,
                                   get_camera_transform(pedestrian))
    world.tick()
    camera_rgb.listen(sensor_queue.put)
    return camera_rgb


def destroy_client_and_world(client, world, sensors=None) -> None:
    """The sensors stopped and destroyed and the world back in
    asynchronous mode, each step on its own: a simulator that is already
    gone fails them, and the teardown goes on with the next."""
    for sensor in (sensors or {}).values():
        try:
            sensor.stop()
            sensor.destroy()
        except RuntimeError:
            pass
    try:
        settings = world.get_settings()
        settings.synchronous_mode = False
        settings.fixed_delta_seconds = None
        world.apply_settings(settings)
    except RuntimeError:
        pass
