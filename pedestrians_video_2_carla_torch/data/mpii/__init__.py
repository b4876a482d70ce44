"""MPII Human Pose data."""
