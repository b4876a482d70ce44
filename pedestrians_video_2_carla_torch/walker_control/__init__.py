"""Host-side walker control: the CARLA-dict pose, the controlled
pedestrian, camera projection of its pose, and the live CARLA endpoint.
The batched math lives in ``ops``; this layer adapts it to CARLA's
types."""
from .carla_utils import carla, mock_carla, using_mock_carla
from .controlled_pedestrian import ControlledPedestrian
from .pose import Pose
from .pose_projection import PoseProjection, RGBCameraMock
