"""CarlaPedestriansEnv on gymnasium's ``(obs, reward, terminated,
truncated, info)`` step API. The pose projection runs on ``device`` (the
card unless the caller names the CPU)."""
import random
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..skeletons.carla import BONE_NAMES
from ..utils.device import DeviceLike
from ..walker_control import carla_utils
from ..walker_control.controlled_pedestrian import ControlledPedestrian
from ..walker_control.pose_projection import PoseProjection

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError:  # pragma: no cover
    gym = None
    spaces = None


class CarlaPedestriansEnv(gym.Env if gym is not None else object):
    metadata = {"render_modes": []}

    def __init__(self, env_id: int = 0, device: DeviceLike = None,
                 **kwargs):
        if gym is None:
            raise ImportError("gymnasium is required for the RL environment")
        super().__init__()
        self.action_space = spaces.Dict({
            "teleport_by": spaces.Dict({
                "location": spaces.Box(low=np.array([-0.1, -0.1, 0.0]),
                                       high=np.array([0.1, 0.1, 0.1]),
                                       shape=(3,)),
                "rotation": spaces.Box(low=-180.0, high=180.0, shape=(1,)),
            }),
            "update_pose": spaces.Dict({
                bone: spaces.Box(low=-18.0, high=18.0, shape=(3,))
                for bone in BONE_NAMES
            }),
        })
        self.observation_space = spaces.Dict({
            "relative_pose": spaces.Dict({
                bone: spaces.Dict({
                    "location": spaces.Box(low=-1.0, high=1.0, shape=(3,)),
                    "rotation": spaces.Box(low=-180.0, high=180.0,
                                           shape=(3,)),
                }) for bone in BONE_NAMES
            }),
            "absolute_pose": spaces.Dict({
                bone: spaces.Dict({
                    "location": spaces.Box(low=-4.0, high=4.0, shape=(3,)),
                    "rotation": spaces.Box(low=-180.0, high=180.0,
                                           shape=(3,)),
                }) for bone in BONE_NAMES
            }),
            "pose_projection": spaces.Box(low=0, high=800, shape=(26, 2)),
        })
        self._env_id = env_id
        self._device = device
        self._length = np.inf
        self._steps = 0
        self._pedestrian: Optional[ControlledPedestrian] = None
        self._pose_projection: Optional[PoseProjection] = None

    def _pose_dict_obs(self, pose_dict):
        return OrderedDict({
            bone: OrderedDict({
                "location": np.asarray([t.location.x, t.location.y,
                                        t.location.z], np.float32),
                "rotation": np.asarray([t.rotation.pitch, t.rotation.yaw,
                                        t.rotation.roll], np.float32),
            }) for bone, t in pose_dict.items()
        })

    def _get_observation(self):
        return OrderedDict({
            "relative_pose": self._pose_dict_obs(
                self._pedestrian.current_pose.relative),
            "absolute_pose": self._pose_dict_obs(
                self._pedestrian.current_pose.absolute),
            "pose_projection":
                self._pose_projection.current_pose_to_points()
                .astype(np.float32),
        })

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            random.seed(seed)
        options = options or {}
        self._pedestrian = ControlledPedestrian(
            None, options.get("age", "adult"),
            options.get("gender", "female"))
        self._pose_projection = PoseProjection(self._pedestrian,
                                               device=self._device)
        if options.get("initial_teleport") is not None:
            self._pedestrian.teleport_by(options["initial_teleport"], True)
        self._steps = 0
        self._length = options.get("length", np.inf)
        return self._get_observation(), {}

    def step(self, action):
        carla = carla_utils.carla
        self._pedestrian.teleport_by(carla.Transform(
            location=carla.Location(
                *np.asarray(action["teleport_by"]["location"],
                            dtype=float).tolist()),
            rotation=carla.Rotation(
                yaw=float(np.asarray(action["teleport_by"]["rotation"],
                                     dtype=float)[0]))))
        self._pedestrian.update_pose({
            bone: carla.Rotation(*np.asarray(rot, dtype=float).tolist())
            for bone, rot in action["update_pose"].items()
        })
        self._steps += 1
        observation = self._get_observation()
        terminated = self._steps >= self._length
        info = {"pedestrian": self._pedestrian,
                "pose_projection": self._pose_projection}
        return observation, 0.0, terminated, False, info

    @property
    def pedestrian(self):
        return self._pedestrian
