"""Camera projection of CARLA-dict poses through the pinhole camera of
``ops/camera.py``: numpy in and out, the projection itself on the
projection's device (the card unless the caller names the CPU)."""
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import camera as C
from ..ops.rotations import euler_angles_to_matrix_np
from ..utils.device import DeviceLike, resolve_device
from . import carla_utils
from .carla_utils import get_camera_transform


class RGBCameraMock:
    """A mock of CARLA's default RGB camera."""

    def __init__(self, pedestrian=None, x: int = 800, y: int = 600, **kwargs):
        self.attributes = {
            "image_size_x": str(x), "image_size_y": str(y),
            "fov": "90.0", "lens_x_size": "0.08", "lens_y_size": "0.08",
        }
        if pedestrian is not None:
            self._transform = get_camera_transform(pedestrian, **kwargs)
        else:
            self._transform = carla_utils.carla.Transform()

    def get_transform(self):
        return self._transform


class PoseProjection:
    """Projects poses through the pinhole camera of a CARLA RGB camera (or
    of a position and a point it looks at)."""

    def __init__(self, pedestrian=None, camera_rgb=None,
                 camera_position: Optional[Tuple[float, float, float]] = None,
                 look_at: Optional[Tuple[float, float, float]] = None,
                 device: DeviceLike = None, **kwargs):
        self.device = resolve_device(device)
        if camera_rgb is None:
            camera_rgb = RGBCameraMock(pedestrian)
        self._pedestrian = pedestrian
        self._image_size = (int(camera_rgb.attributes["image_size_x"]),
                            int(camera_rgb.attributes["image_size_y"]))
        fov = float(camera_rgb.attributes["fov"])

        if camera_position is not None:
            distance, shift, elevation = camera_position
            self.camera = C.make_camera(
                distance=distance, shift=shift, elevation=elevation,
                look_at=(look_at[0], look_at[1], -look_at[2])
                if look_at is not None else None,
                image_size=self._image_size, fov_deg=fov)
        else:
            distance, elevation = self._distance_and_elevation(camera_rgb)
            self.camera = C.make_camera(
                distance=distance, elevation=elevation,
                image_size=self._image_size, fov_deg=fov)

    def _distance_and_elevation(self, camera_rgb):
        if self._pedestrian is None:
            return C.DEFAULT_CAMERA_DISTANCE, C.DEFAULT_CAMERA_ELEVATION
        cam_t = camera_rgb.get_transform().location
        ped_t = self._pedestrian.world_transform.location
        shift = self._pedestrian.spawn_shift
        return (cam_t.x - ped_t.x + shift.x, cam_t.z - ped_t.z + shift.z)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self._image_size

    def _tensor(self, array):
        if array is None:
            return None
        return torch.as_tensor(np.asarray(array, dtype=np.float32),
                               device=self.device)

    def project(self, absolute_pose_loc: np.ndarray,
                world_loc: Optional[np.ndarray] = None,
                world_rot: Optional[np.ndarray] = None) -> np.ndarray:
        """(..., J, 3) P3D-space pose -> (..., J, 2) screen pixels, as a
        float32 numpy array."""
        out = C.project_pose(self.camera, self._tensor(absolute_pose_loc),
                             world_loc=self._tensor(world_loc),
                             world_rot=self._tensor(world_rot))
        return out[..., :2].cpu().numpy()

    def current_pose_to_points(self) -> np.ndarray:
        """The bound pedestrian's current absolute pose, projected:
        (26, 2) pixels."""
        absolute = self._pedestrian.current_pose.absolute
        abs_loc = np.asarray(
            [[t.location.x, t.location.y, -t.location.z]
             for t in absolute.values()], dtype=np.float32)
        root = self._pedestrian.transform
        loc = np.asarray([[root.location.x, root.location.y,
                           -root.location.z]], dtype=np.float32)
        angles = np.deg2rad(np.asarray(
            [-root.rotation.roll, -root.rotation.pitch, -root.rotation.yaw]))
        rot = euler_angles_to_matrix_np(angles, "XYZ")[None].astype(np.float32)
        return self.project(abs_loc[None], loc, rot)[0]
