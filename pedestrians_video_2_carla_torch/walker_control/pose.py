"""The CARLA-dict pose: an ordered ``{bone_name: carla.Transform}`` of the
relative pose, with the absolute pose computed by forward kinematics over
the skeleton's tree when it is read after a change. A host-side adapter of
float64 numpy, for the code that controls CARLA walkers; the batched
tensor path is ``ops/kinematics.py``."""
import time
from collections import OrderedDict
from typing import Dict

import numpy as np

from ..ops.rotations import euler_angles_to_matrix_np
from ..skeletons.carla import (BONE_NAMES, PARENTS, load_reference_pose_carla,
                               reference_pose_key)
from . import carla_utils
from .carla_utils import (deepcopy_transform, mul_carla_rotations,
                          transform_location)


class Pose:
    def __init__(self, structure=None, **kwargs):
        self._relative_pose = OrderedDict((n, None) for n in BONE_NAMES)
        self._last_rel_mod = time.time_ns()
        self._last_abs_mod = None
        self._last_abs = None

    @staticmethod
    def _deepcopy_pose_dict(pose_dict):
        return OrderedDict(
            (name, deepcopy_transform(t) if t is not None else None)
            for name, t in pose_dict.items())

    @property
    def empty(self):
        return OrderedDict((n, None) for n in BONE_NAMES)

    @property
    def relative(self):
        return self._deepcopy_pose_dict(self._relative_pose)

    @relative.setter
    def relative(self, new_pose_dict):
        self._relative_pose.update(new_pose_dict)
        self._last_rel_mod = time.time_ns()

    @property
    def absolute(self):
        """Component-space transforms (CARLA's ``WalkerBoneControlOut``
        'component'), computed again after a change of the relative
        pose."""
        if self._last_abs_mod != self._last_rel_mod:
            absolute = self.empty
            relative = self.relative
            for i, name in enumerate(BONE_NAMES):
                p = PARENTS[i]
                if p < 0:
                    absolute[name] = deepcopy_transform(relative[name])
                    continue
                parent_t = absolute[BONE_NAMES[p]]
                absolute[name] = carla_utils.carla.Transform(
                    location=transform_location(parent_t,
                                                relative[name].location),
                    rotation=mul_carla_rotations(parent_t.rotation,
                                                 relative[name].rotation))
            self._last_abs = absolute
            self._last_abs_mod = self._last_rel_mod
        return self._deepcopy_pose_dict(self._last_abs)

    def move(self, rotations: Dict[str, "carla.Rotation"]):
        """Per-bone rotation changes merged into the relative pose."""
        new_pose = self.relative
        for bone_name, rotation_change in rotations.items():
            new_pose[bone_name].rotation = mul_carla_rotations(
                new_pose[bone_name].rotation, rotation_change)
        self.relative = new_pose

    def tensors(self):
        """The relative pose as P3D-convention float32 numpy arrays
        ``(loc (26, 3), rot (26, 3, 3))``."""
        loc = np.asarray([[t.location.x, t.location.y, -t.location.z]
                          for t in self._relative_pose.values()],
                         dtype=np.float32)
        pyr = np.asarray([[t.rotation.pitch, t.rotation.yaw, t.rotation.roll]
                          for t in self._relative_pose.values()])
        angles = np.deg2rad(
            np.stack([-pyr[:, 2], -pyr[:, 0], -pyr[:, 1]], axis=-1))
        rot = euler_angles_to_matrix_np(angles, "XYZ").astype(np.float32)
        return loc, rot


def load_reference_pose_dict(age: str = "adult", gender: str = "female"):
    """The reference relative pose as a CARLA dict, and the root<->hips
    transform."""
    carla = carla_utils.carla
    loc, pyr, (hips_loc, root_rot) = load_reference_pose_carla(
        reference_pose_key(age, gender))
    pose = OrderedDict()
    for i, name in enumerate(BONE_NAMES):
        pose[name] = carla.Transform(
            location=carla.Location(*loc[i].tolist()),
            rotation=carla.Rotation(pitch=float(pyr[i][0]),
                                    yaw=float(pyr[i][1]),
                                    roll=float(pyr[i][2])))
    root_hips_transform = carla.Transform(
        location=carla.Location(*hips_loc.tolist()),
        rotation=carla.Rotation(pitch=float(root_rot[0]),
                                yaw=float(root_rot[1]),
                                roll=float(root_rot[2])))
    return pose, root_hips_transform
