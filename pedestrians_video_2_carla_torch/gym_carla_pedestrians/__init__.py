"""A gymnasium environment of one controlled pedestrian: the action is
per-bone rotation changes and a teleport, the observation the relative
and absolute pose and its 2D projection, the reward 0. Registered as
``CarlaPedestrians-v0`` where gymnasium is installed (it is optional).

The JAX package registers the same id with its own entry point. In a
process that imports both packages, the later registration wins and
gymnasium warns; so code that needs one package's environment for certain
(the parity tests) builds the classes directly instead of calling
``gym.make``."""
try:
    from gymnasium.envs.registration import register

    register(id="CarlaPedestrians-v0",
             entry_point="pedestrians_video_2_carla_torch."
                         "gym_carla_pedestrians.envs:CarlaPedestriansEnv")
except ImportError:  # gymnasium is optional
    pass

from .envs import CarlaPedestriansEnv  # noqa: E402,F401
from .wrappers import (CarlaRenderWrapper,  # noqa: E402,F401
                       NumpyToDictActionWrapper, PoseOverlayRenderWrapper)
