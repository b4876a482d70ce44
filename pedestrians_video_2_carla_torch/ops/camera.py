"""Pinhole camera: look-at view transform + screen-space projection.

The screen formula (pytorch3d v0.6.0 semantics) is

    x_screen = W - (fx * x_view / z_view + px)
    y_screen = H - (fy * y_view / z_view + py)

with pytorch3d view axes (+X left, +Y up, +Z into the screen). The third
output channel is the view-space depth ``z_view``.

The camera's ``R`` and ``T`` are built in float32, in the same order of
operations as the JAX package, and then used as Python floats: the
projection is elementwise arithmetic over the batch planes, and the CUDA
kernel receives the same 18 constants.
"""
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .rotations import _cross, mm

DEFAULT_IMAGE_SIZE = (800, 600)   # (width, height)
DEFAULT_FOV_DEG = 90.0
DEFAULT_LENS_SIZE_M = 0.08        # CARLA RGB camera lens_x_size
DEFAULT_CAMERA_DISTANCE = 3.1     # m in front of pedestrian
DEFAULT_CAMERA_ELEVATION = 1.2    # m above ground


def look_at_view_transform(eye, at, up) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-vector world->view transform ``X_view = X_world @ R + T``
    (pytorch3d-compatible: ``z = normalize(at - eye)``,
    ``x = normalize(up x z)``, ``y = normalize(z x x)``, ``R = [x; y; z]^T``,
    ``T = -eye @ R``). Float32 CPU tensors."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    at = torch.as_tensor(at, dtype=torch.float32)
    up = torch.as_tensor(up, dtype=torch.float32)

    def _norm(v):
        # clamp the summed squares before the sqrt (finite VJP at zero)
        sq = (v * v).sum(-1, keepdim=True)
        return v / torch.sqrt(torch.clamp(sq, min=1e-10))

    z_axis = _norm(at - eye)
    x_axis = _norm(_cross(up, z_axis))
    y_axis = _norm(_cross(z_axis, x_axis))
    R = torch.stack([x_axis, y_axis, z_axis], dim=-2).transpose(-1, -2)
    T = -mm(eye[None], R)[0]
    return R, T


class PinholeCamera(NamedTuple):
    """Static camera parameters. ``consts`` holds the projection's 18
    constants as Python floats, computed once where the camera is made
    (:func:`make_camera`, :func:`camera_from_constants`), so that
    projecting reads no tensor values: under ``torch.export`` R and T
    would be fake tensors."""
    R: torch.Tensor                   # (3, 3) world->view rotation (row-vector)
    T: torch.Tensor                   # (3,) world->view translation
    focal: Tuple[float, float]        # (fx, fy) pixels
    principal: Tuple[float, float]    # (px, py) pixels
    image_size: Tuple[int, int]       # (width, height)
    consts: Tuple[float, ...]         # the 18 of constants()

    def constants(self) -> Tuple[float, ...]:
        """The 18 float constants of the projection, in the CUDA kernel's
        order: R row-major, T, fx, fy, px, py, W, H."""
        return self.consts

    def project_planes(self, x, y, z0):
        """3 (...) world component planes -> (x_screen, y_screen, depth)."""
        (r00, r01, r02, r10, r11, r12, r20, r21, r22,
         t0, t1, t2, fx, fy, px, py, w, h) = self.constants()
        vx = x * r00 + y * r10 + z0 * r20 + t0
        vy = x * r01 + y * r11 + z0 * r21 + t1
        vz = x * r02 + y * r12 + z0 * r22 + t2
        inv_z = 1.0 / vz
        x_screen = w - (fx * vx * inv_z + px)
        y_screen = h - (fy * vy * inv_z + py)
        return x_screen, y_screen, vz


def focal_px_from_fov(fov_deg: float, lens_size_m: float = DEFAULT_LENS_SIZE_M) -> float:
    """focal_mm = sensor_width_mm / (2 tan(fov/2)), passed as focal_mm * 10,
    which with the 80 mm sensor and 800 px width is W / (2 tan(fov/2)) px."""
    sensor_width_mm = lens_size_m * 1000.0
    return float(sensor_width_mm / (2.0 * np.tan(np.deg2rad(fov_deg) / 2.0)) * 10.0)


def make_camera(distance: float = DEFAULT_CAMERA_DISTANCE,
                shift: float = 0.0,
                elevation: float = DEFAULT_CAMERA_ELEVATION,
                look_at: Optional[Tuple[float, float, float]] = None,
                image_size: Tuple[int, int] = DEFAULT_IMAGE_SIZE,
                fov_deg: float = DEFAULT_FOV_DEG) -> PinholeCamera:
    """The default mock-CARLA camera in P3D world coordinates (z negated vs
    CARLA, hence ``-elevation``)."""
    eye = (distance, shift, -elevation)
    if look_at is None:
        look_at = (0.0, 0.0, -elevation)
    R, T = look_at_view_transform(eye=eye, at=look_at, up=(0.0, 0.0, -1.0))
    f = focal_px_from_fov(fov_deg)
    w, h = image_size
    focal, principal = (f, f), (w / 2.0, h / 2.0)
    consts = tuple(float(v) for v in (
        *R.reshape(9).tolist(), *T.tolist(), *focal, *principal, w, h))
    return PinholeCamera(R=R, T=T, focal=focal, principal=principal,
                         image_size=(w, h), consts=consts)


@lru_cache(maxsize=None)
def camera_from_constants(consts: Tuple[float, ...]) -> PinholeCamera:
    """The camera of 18 constants in :meth:`PinholeCamera.constants`' order
    (the float32 values of R and T round-trip exactly), made once per
    tuple: the kernels' ``torch.library`` ops take a camera as its
    constants."""
    consts = tuple(float(v) for v in consts)
    if len(consts) != 18:
        raise ValueError(f"a camera has 18 constants, got {len(consts)}")
    return PinholeCamera(
        R=torch.tensor(consts[:9]).reshape(3, 3), T=torch.tensor(consts[9:12]),
        focal=consts[12:14], principal=consts[14:16],
        image_size=tuple(int(v) for v in consts[16:18]), consts=consts)


def project_pose(camera: PinholeCamera,
                 abs_pose_loc: torch.Tensor,
                 world_loc: Optional[torch.Tensor] = None,
                 world_rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project absolute (component-space) pose locations to the screen.

    :param abs_pose_loc: (..., J, 3) absolute pose in P3D pose space.
    :param world_loc: broadcastable (..., 3) pedestrian world location.
    :param world_rot: broadcastable (..., 3, 3) pedestrian world rotation.
    :return: (..., J, 3) = (x_screen, y_screen, depth).
    """
    sx, sy, vz = project_pose_planes(
        camera,
        (abs_pose_loc[..., 0], abs_pose_loc[..., 1], abs_pose_loc[..., 2]),
        world_loc=world_loc, world_rot=world_rot)
    return torch.stack([sx, sy, vz], dim=-1)


def project_pose_planes(camera: PinholeCamera, abs_loc_planes,
                        world_loc: Optional[torch.Tensor] = None,
                        world_rot: Optional[torch.Tensor] = None):
    """Plane form of :func:`project_pose`: 3 (..., J) absolute-location
    planes -> (x_screen, y_screen, depth) planes."""
    x, y, z = abs_loc_planes
    # p3d pose -> p3d world axis swap: (x, y, z) -> (y, -x, z)
    wx, wy, wz = y, -x, z
    if world_rot is not None:
        # (..., 3, 3) per-clip rotation broadcast over the joint axis
        r = world_rot[..., None, :, :]
        wx, wy, wz = (
            wx * r[..., 0, 0] + wy * r[..., 1, 0] + wz * r[..., 2, 0],
            wx * r[..., 0, 1] + wy * r[..., 1, 1] + wz * r[..., 2, 1],
            wx * r[..., 0, 2] + wy * r[..., 1, 2] + wz * r[..., 2, 2],
        )
    if world_loc is not None:
        wx = wx + world_loc[..., None, 0]
        wy = wy + world_loc[..., None, 1]
        wz = wz + world_loc[..., None, 2]
    return camera.project_planes(wx, wy, wz)
