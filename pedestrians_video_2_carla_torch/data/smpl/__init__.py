"""SMPL body model and AMASS mocap data."""
