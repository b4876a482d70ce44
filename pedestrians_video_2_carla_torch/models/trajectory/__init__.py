"""Trajectory models (world-track prediction)."""
from .zero import TrajectoryModel, ZeroTrajectory

TRAJECTORY_MODELS = {m.__name__: m for m in [ZeroTrajectory]}
