"""CARLA pedestrian skeleton: the 26-bone tree, its static FK arrays and the
UE4 reference poses, read from the port's own copies of ``structure.json``
and ``reference_poses.json``.

The bone order is the depth-first traversal of the UE4 skeleton tree, which
is also the bone-dimension order of every tensor. Exported:
  * ``PARENTS``     -- (26,) parent index per bone (-1 for the root);
  * ``TOPO_LEVELS`` -- bones grouped by tree depth (8 levels); bones within a
                       level are independent, so FK runs level by level. The
                       CUDA kernel gets its tree from these arrays too.
"""
import json
import os
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from .base import Skeleton, register_skeleton

_FILES_DIR = os.path.join(os.path.dirname(__file__), "files")

with open(os.path.join(_FILES_DIR, "structure.json")) as _f:
    _STRUCTURE = json.load(_f)

BONE_NAMES: List[str] = _STRUCTURE["names"]
PARENTS: np.ndarray = np.asarray(_STRUCTURE["parents"], dtype=np.int32)
NUM_BONES: int = len(BONE_NAMES)

CARLA_SKELETON = Skeleton("CARLA_SKELETON", [(n, i) for i, n in enumerate(BONE_NAMES)])


def _compute_depths(parents: np.ndarray) -> np.ndarray:
    depth = np.zeros(len(parents), dtype=np.int32)
    for i, p in enumerate(parents):
        if p >= i:
            raise ValueError("skeleton parents must precede their children")
        depth[i] = 0 if p < 0 else depth[p] + 1
    return depth


#: tree depth of each bone (the root is 0)
BONE_DEPTHS: np.ndarray = _compute_depths(PARENTS)

#: bones grouped by depth; level 0 is the root
TOPO_LEVELS: List[np.ndarray] = [
    np.nonzero(BONE_DEPTHS == d)[0].astype(np.int32)
    for d in range(int(BONE_DEPTHS.max()) + 1)]

def _carla_flip_mask() -> Tuple[int, ...]:
    """Swap the __L and __R bones; __C bones and the root stay."""
    swap = {"__L": "__R", "__R": "__L"}
    return tuple(BONE_NAMES.index(name[:-3] + swap[name[-3:]])
                 if name[-3:] in swap else i
                 for i, name in enumerate(BONE_NAMES))


CARLA_SKELETON.get_flip_mask = classmethod(lambda cls: _carla_flip_mask())
# one green for every joint, as the video renderers draw CARLA skeletons
CARLA_SKELETON.get_colors = classmethod(
    lambda cls: {k: (0, 255, 0, 255) for k in CARLA_SKELETON})
CARLA_SKELETON.get_edges = classmethod(lambda cls: [
    (CARLA_SKELETON(int(PARENTS[i])), CARLA_SKELETON(i))
    for i in range(NUM_BONES) if PARENTS[i] >= 0])
CARLA_SKELETON.get_neck_point = classmethod(lambda cls: CARLA_SKELETON.crl_neck__C)
CARLA_SKELETON.get_hips_point = classmethod(lambda cls: CARLA_SKELETON.crl_hips__C)

register_skeleton("CARLA_SKELETON", CARLA_SKELETON, [(k, k) for k in CARLA_SKELETON])


# ---------------------------------------------------------------------------
# UE4 reference poses
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _reference_poses_raw() -> Dict[str, dict]:
    with open(os.path.join(_FILES_DIR, "reference_poses.json")) as f:
        return json.load(f)


AGE_GENDER_KEYS = ("adult_female", "adult_male", "child_female", "child_male")


def reference_pose_key(age: str, gender: str) -> str:
    return f"{age}_{gender}"


@lru_cache(maxsize=None)
def load_reference_pose_carla(key: str = "adult_female"):
    """Reference relative pose in **CARLA units/convention**:
    ``(loc (26, 3) m, rot_pyr (26, 3) deg (pitch, yaw, roll),
    root_hips_transform)``, with the hips location re-zeroed and kept as the
    root<->hips offset."""
    raw = _reference_poses_raw()[key]
    loc = np.asarray([raw[n]["location"] for n in BONE_NAMES], dtype=np.float64) / 100.0
    rot = np.asarray([raw[n]["rotation"] for n in BONE_NAMES], dtype=np.float64)

    hips = int(CARLA_SKELETON.crl_hips__C)
    root = int(CARLA_SKELETON.crl_root)
    root_hips_transform = (loc[hips].copy(), rot[root].copy())
    loc[hips] = 0.0
    return loc, rot, root_hips_transform


@lru_cache(maxsize=None)
def load_reference_pose(key: str = "adult_female"):
    """Reference relative pose in the **P3D tensor convention**: locations
    ``(x, y, -z)`` m, rotations (26, 3, 3) from radians
    ``(-roll, -pitch, -yaw)`` in euler order "XYZ". Float32 numpy
    ``(rel_loc (26, 3), rel_rot (26, 3, 3))``."""
    from ..ops.rotations import euler_angles_to_matrix_np

    loc, rot_pyr, _ = load_reference_pose_carla(key)
    p3d_loc = np.stack([loc[:, 0], loc[:, 1], -loc[:, 2]], axis=-1)
    angles = np.deg2rad(
        np.stack([-rot_pyr[:, 2], -rot_pyr[:, 0], -rot_pyr[:, 1]], axis=-1))
    p3d_rot = euler_angles_to_matrix_np(angles, "XYZ")
    return p3d_loc.astype(np.float32), p3d_rot.astype(np.float32)


def reference_poses_tensor():
    """All four reference skeletons stacked, in ``AGE_GENDER_KEYS`` order:
    float32 numpy ``(rel_loc (4, 26, 3), rel_rot (4, 26, 3, 3))``."""
    locs, rots = zip(*[load_reference_pose(k) for k in AGE_GENDER_KEYS])
    return np.stack(locs), np.stack(rots)


#: substitutions for dataset labels that CARLA has no walker for
AGE_MAPPINGS = {"adult": "adult", "child": "child",
                "senior": "adult", "young": "child"}
GENDER_MAPPINGS = {"female": "female", "male": "male", "neutral": "female"}


def age_gender_to_index(age, gender) -> int:
    """(age, gender) strings -> an index into ``AGE_GENDER_KEYS``; unknown
    or NaN values fall back to 'adult' / 'female'."""
    age = AGE_MAPPINGS.get(str(age), "adult")
    gender = GENDER_MAPPINGS.get(str(gender), "female")
    return AGE_GENDER_KEYS.index(f"{age}_{gender}")
