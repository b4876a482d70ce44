"""Gymnasium wrappers: a flat-array action adapter, CARLA camera
rendering, and the pose's points drawn over the rendered frames."""
from collections import OrderedDict
from queue import Empty, Queue
from typing import Any, Optional

import numpy as np

from ..skeletons.carla import BONE_NAMES
from ..walker_control.carla_utils import (destroy_client_and_world,
                                          setup_camera,
                                          setup_client_and_world,
                                          using_mock_carla)

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    gym = None


class NumpyToDictActionWrapper(gym.ActionWrapper if gym else object):
    """A (28, 3) float array -> the env's Dict action: row 0 the teleport's
    location, row 1 ``[pitch, yaw, roll]`` of which only the yaw is used,
    rows 2.. the per-bone rotations in CARLA's bone order."""

    def action(self, action: np.ndarray) -> OrderedDict:
        action = np.asarray(action, dtype=np.float32)
        return OrderedDict({
            "teleport_by": {
                "location": action[0, :],
                "rotation": action[1, 1:2],  # the yaw alone
            },
            "update_pose": dict(zip(BONE_NAMES, action[2:, :])),
        })


class CarlaRenderWrapper(gym.Wrapper if gym else object):
    """``rgb_array`` rendering: on reset, a client and world set up, the
    pedestrian bound and a synchronous camera attached, whose queue each
    render drains. Under the mock carla module (no server) it renders a
    black canvas; stack ``PoseOverlayRenderWrapper`` on it for a skeleton
    view."""

    def __init__(self, env, fps: float = 30.0):
        super().__init__(env)
        self.metadata = {**self.env.metadata,
                         "render_modes":
                         sorted({*self.env.metadata.get("render_modes", []),
                                 "rgb_array"}),
                         "render_fps": fps}
        self._fps = fps
        self._client = None
        self._world = None
        self._sensors = None
        self._camera_queue = None

    def reset(self, **kwargs) -> Any:
        self.close_carla()
        out = super().reset(**kwargs)
        if not using_mock_carla():
            self._client, self._world = setup_client_and_world(fps=self._fps)
            pedestrian = self.unwrapped.pedestrian
            pedestrian.bind(self._world)
            self._camera_queue = Queue()
            camera = setup_camera(self._world, self._camera_queue, pedestrian)
            self._sensors = {"camera_rgb": camera}
        return out

    def close_carla(self):
        if self._client is not None and self._world is not None:
            destroy_client_and_world(self._client, self._world, self._sensors)
        self._client = self._world = self._sensors = None

    def close(self):
        super().close()
        self.close_carla()

    def render(self) -> Optional[np.ndarray]:
        if self._world is not None and self._camera_queue is not None:
            self._world.tick()
            try:
                image = self._camera_queue.get(timeout=2.0)
            except Empty:
                return None
            arr = np.frombuffer(image.raw_data, dtype=np.uint8)
            return arr.reshape(image.height, image.width, 4)[..., :3]
        w, h = 800, 600
        proj = getattr(self.unwrapped, "_pose_projection", None)
        if proj is not None:
            w, h = proj.image_size
        return np.zeros((h, w, 3), dtype=np.uint8)


class PoseOverlayRenderWrapper(gym.Wrapper if gym else object):
    """The current 2D pose projection drawn over the rendered frames."""

    def __init__(self, env):
        super().__init__(env)
        self._last_projection: Optional[np.ndarray] = None
        from ..renderers.points_renderer import PointsRenderer
        self._points = PointsRenderer()

    def _remember(self, observation):
        pts = observation.get("pose_projection")
        if pts is not None:
            self._last_projection = np.asarray(pts, dtype=np.float32)

    def reset(self, **kwargs):
        observation, info = super().reset(**kwargs)
        self._remember(observation)
        return observation, info

    def step(self, action):
        observation, reward, terminated, truncated, info = super().step(action)
        self._remember(observation)
        return observation, reward, terminated, truncated, info

    def render(self) -> Optional[np.ndarray]:
        frame = super().render()
        if frame is None or self._last_projection is None:
            return frame
        frame = np.ascontiguousarray(frame)
        return self._points.render_frame(self._last_projection, canvas=frame)
