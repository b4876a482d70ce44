"""MPII Human Pose's 16-joint skeleton and its mapping to CARLA."""
from .base import register_skeleton
from .carla import CARLA_SKELETON
from .factory import lr_flip_map, make_skeleton

_MPII_JOINTS = (
    "RAnkle", "RKnee", "RHip", "LHip", "LKnee", "LAnkle", "Pelvis",
    "Thorax", "Neck", "Head", "RWrist", "RElbow", "RShoulder",
    "LShoulder", "LElbow", "LWrist",
)

MPII_SKELETON = make_skeleton(
    "MPII_SKELETON",
    joints=_MPII_JOINTS,
    edges=[
        ("Head", "Neck"), ("Neck", "RShoulder"), ("Neck", "LShoulder"),
        ("RShoulder", "RElbow"), ("RElbow", "RWrist"),
        ("LShoulder", "LElbow"), ("LElbow", "LWrist"),
        ("Neck", "Thorax"), ("Thorax", "Pelvis"),
        ("Pelvis", "RHip"), ("RHip", "RKnee"), ("RKnee", "RAnkle"),
        ("Pelvis", "LHip"), ("LHip", "LKnee"), ("LKnee", "LAnkle"),
    ],
    hips=["Pelvis"], neck=["Neck"],
    colors={
        "RAnkle": (0, 255, 255, 255), "RKnee": (0, 255, 170, 255),
        "RHip": (0, 255, 85, 255), "LHip": (0, 170, 255, 255),
        "LKnee": (0, 85, 255, 255), "LAnkle": (0, 0, 255, 255),
        "Pelvis": (255, 0, 0, 255), "Thorax": (255, 0, 0, 192),
        "Neck": (255, 0, 0, 192), "Head": (255, 0, 85, 255),
        "RWrist": (255, 255, 0, 255), "RElbow": (255, 170, 0, 255),
        "RShoulder": (255, 85, 0, 255), "LShoulder": (170, 255, 0, 255),
        "LElbow": (85, 255, 0, 255), "LWrist": (0, 255, 0, 255),
    },
    flip_map=lr_flip_map(_MPII_JOINTS),
)

register_skeleton("MPII_SKELETON", MPII_SKELETON, [
    (CARLA_SKELETON[c], MPII_SKELETON[j]) for c, j in {
        "crl_arm__L": "LShoulder", "crl_foreArm__L": "LElbow",
        "crl_hand__L": "LWrist", "crl_neck__C": "Neck",
        "crl_Head__C": "Head", "crl_arm__R": "RShoulder",
        "crl_foreArm__R": "RElbow", "crl_hand__R": "RWrist",
        "crl_hips__C": "Pelvis", "crl_thigh__R": "RHip",
        "crl_leg__R": "RKnee", "crl_foot__R": "RAnkle",
        "crl_thigh__L": "LHip", "crl_leg__L": "LKnee",
        "crl_foot__L": "LAnkle",
    }.items()
])
