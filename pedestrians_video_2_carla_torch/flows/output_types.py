"""Model output-type enums (reference ``modules/flow/output_types.py:1-44``)."""
from enum import Enum


class MovementsModelOutputType(Enum):
    pose_changes = 0       # default/preferred: per-frame bone rotation deltas
    absolute_loc_rot = 1   # absolute component-space (loc, rot) pairs
    absolute_loc = 2       # absolute component-space locations only
    relative_rot = 3       # per-frame relative bone rotations
    pose_2d = 4            # 2D pose -> 2D pose (autoencoder flow)


class TrajectoryModelOutputType(Enum):
    changes = 0  # default: per-frame world loc/rot deltas
    loc_rot = 1  # direct per-frame world loc/rot


class ClassificationModelOutputType(Enum):
    multiclass = 0  # default
    binary = 1


class PoseEstimationModelOutputType(Enum):
    heatmaps = 100  # default
    pose_2d = 4
