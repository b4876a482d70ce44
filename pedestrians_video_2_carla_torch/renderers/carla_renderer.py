"""Live-CARLA renderer: a walker spawned, each frame's predicted pose
applied and its teleport made, the RGB camera's queue drained. It needs a
reachable CARLA server; under the mock client it yields black frames.

The clips' rotation matrices become CARLA rotations in one batched
conversion on their tensor's device (``ops/rotations.py::
matrix_to_carla_rotation``), copied to the host once; the loop over
frames then reads host floats.
"""
from queue import Empty, Queue
from typing import Iterable, Optional

import numpy as np
import torch

from ..ops.rotations import matrix_to_carla_rotation
from ..skeletons.carla import BONE_NAMES
from ..walker_control import carla_utils
from ..walker_control.carla_utils import (destroy_client_and_world,
                                          setup_camera,
                                          setup_client_and_world,
                                          using_mock_carla)
from ..walker_control.controlled_pedestrian import ControlledPedestrian
from ..walker_control.pose import Pose
from .renderer import Renderer


def carla_rotations(relative_pose_rot) -> np.ndarray:
    """(..., 26, 3, 3) P3D matrices (a tensor on any device, or an array)
    -> (..., 26, 3) float32 degrees (pitch, yaw, roll) on the host:
    converted on the tensor's device, then copied once."""
    rot = torch.as_tensor(relative_pose_rot, dtype=torch.float32)
    return matrix_to_carla_rotation(rot).cpu().numpy()


def _host(array) -> Optional[np.ndarray]:
    if array is None:
        return None
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


class CarlaRenderer(Renderer):
    def __init__(self, fps: float = 30.0, timeout: float = 10.0, **kwargs):
        super().__init__(**kwargs)
        self.fps = fps
        self.timeout = timeout

    def render(self, relative_pose_loc=None, relative_pose_rot=None,
               world_loc=None, world_rot=None, meta=None,
               **kwargs) -> Iterable[np.ndarray]:
        batch = len(relative_pose_rot)
        clip_length = relative_pose_rot.shape[1]
        if using_mock_carla():
            for _ in range(batch):
                yield self.zeros(clip_length)
            return

        pyr = carla_rotations(relative_pose_rot)
        world_loc = _host(world_loc)
        meta = meta or {}
        ages = meta.get("age", ["adult"] * batch)
        genders = meta.get("gender", ["female"] * batch)
        client, world = setup_client_and_world(fps=self.fps)
        try:
            for idx in range(batch):
                yield self.play_clip(
                    world, pyr[idx],
                    world_loc[idx] if world_loc is not None else None,
                    age=ages[idx], gender=genders[idx])
        finally:
            destroy_client_and_world(client, world)

    def render_clip(self, world, rel_loc, rel_rot, world_loc, world_rot,
                    age: str, gender: str) -> np.ndarray:
        """One clip: (L, 26, 3, 3) relative rotations (the locations and
        world rotations are not applied: CARLA's walker keeps its own
        bone lengths and the teleports carry no turn)."""
        return self.play_clip(world, carla_rotations(rel_rot),
                              _host(world_loc), age, gender)

    def play_clip(self, world, pyr: np.ndarray,
                  world_loc: Optional[np.ndarray], age: str,
                  gender: str) -> np.ndarray:
        """One clip from its (L, 26, 3) host rotations in degrees: a
        walker spawned, each frame's pose applied and its teleport made,
        a tick, the camera's frame (black where none came in time)."""
        carla = carla_utils.carla
        pedestrian = ControlledPedestrian(world, age, gender,
                                          reference_pose=Pose)
        sensor_queue: Queue = Queue()
        camera = setup_camera(world, sensor_queue, pedestrian,
                              image_size=self._image_size)
        frames = []
        clip_length = len(pyr)
        try:
            prev_loc = np.zeros(3)
            for i in range(clip_length):
                pose = pedestrian.current_pose.relative
                for j, name in enumerate(BONE_NAMES):
                    pose[name].rotation = carla.Rotation(
                        pitch=float(pyr[i, j, 0]), yaw=float(pyr[i, j, 1]),
                        roll=float(pyr[i, j, 2]))
                pedestrian.current_pose.relative = pose
                pedestrian.apply_pose()
                if world_loc is not None:
                    delta = world_loc[i] - prev_loc
                    prev_loc = world_loc[i]
                    pedestrian.teleport_by(carla.Transform(
                        location=carla.Location(
                            x=float(delta[0]), y=float(delta[1]),
                            z=float(-delta[2]))))
                world.tick()
                try:
                    image = sensor_queue.get(timeout=self.timeout)
                    array = np.frombuffer(image.raw_data, dtype=np.uint8)
                    array = array.reshape(
                        (image.height, image.width, 4))[..., 2::-1]
                    frames.append(array.copy())
                except Empty:
                    frames.append(self.zeros(1)[0])
        finally:
            camera.stop()
            camera.destroy()
            if pedestrian.walker is not None:
                pedestrian.walker.destroy()
        return np.stack(frames) if frames else self.zeros(clip_length)
