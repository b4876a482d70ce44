"""Pose-estimation models (clips of frames -> 2D pose, directly or through
heatmaps): the JAX package's registry."""
from .linear import Linear, PoseEstimationModel
from .regular import AvPedestrianPoseTransformer, P0
from .unipose_lstm import UniPoseLSTM

POSE_ESTIMATION_MODELS = {
    "Linear": Linear,
    "UniPoseLSTM": UniPoseLSTM,
    "P0": P0,
    "AvPedestrianPoseTransformer": AvPedestrianPoseTransformer,
}


def register_pose_estimation_model(cls):
    POSE_ESTIMATION_MODELS[cls.__name__] = cls
    return cls
