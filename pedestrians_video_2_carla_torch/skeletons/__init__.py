"""Skeleton definitions, registries and cross-skeleton mappings: CARLA and
the OpenPose BODY_25 / COCO skeletons."""
from .base import (MAPPINGS, SKELETONS, Skeleton, common_hips_index,
                   get_common_indices, get_skeleton_name_by_type,
                   get_skeleton_type_by_name, map_pose, register_skeleton)
from .carla import (AGE_GENDER_KEYS, BONE_DEPTHS, BONE_NAMES, CARLA_SKELETON,
                    NUM_BONES, PARENTS, TOPO_LEVELS, load_reference_pose,
                    load_reference_pose_carla, reference_poses_tensor)
from .openpose import BODY_25_SKELETON, COCO_SKELETON

__all__ = [
    "Skeleton", "SKELETONS", "MAPPINGS", "register_skeleton",
    "get_common_indices", "common_hips_index", "get_skeleton_type_by_name",
    "get_skeleton_name_by_type", "map_pose",
    "CARLA_SKELETON", "BODY_25_SKELETON", "COCO_SKELETON",
    "BONE_NAMES", "PARENTS", "NUM_BONES", "TOPO_LEVELS",
    "BONE_DEPTHS", "AGE_GENDER_KEYS", "load_reference_pose",
    "load_reference_pose_carla", "reference_poses_tensor",
]
