"""Skeleton definitions and registries (the CARLA skeleton only, for now)."""
from .base import (MAPPINGS, SKELETONS, Skeleton, common_hips_index,
                   get_common_indices, register_skeleton)
from .carla import (AGE_GENDER_KEYS, BONE_DEPTHS, BONE_NAMES, CARLA_SKELETON,
                    NUM_BONES, PARENTS, TOPO_LEVELS, load_reference_pose,
                    load_reference_pose_carla, reference_poses_tensor)

__all__ = [
    "Skeleton", "SKELETONS", "MAPPINGS", "register_skeleton",
    "get_common_indices", "common_hips_index",
    "CARLA_SKELETON", "BONE_NAMES", "PARENTS", "NUM_BONES", "TOPO_LEVELS",
    "BONE_DEPTHS", "AGE_GENDER_KEYS", "load_reference_pose",
    "load_reference_pose_carla", "reference_poses_tensor",
]
