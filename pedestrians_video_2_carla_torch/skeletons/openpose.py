"""OpenPose BODY_25 and COCO skeletons, their flip maps and colours, and
their mappings onto the CARLA skeleton (registered in ``MAPPINGS``)."""
from .base import register_skeleton
from .carla import CARLA_SKELETON
from .factory import lr_flip_map, make_skeleton

# OpenPose color scheme (kept for visual comparison of rendered skeletons)
_OP_COLORS = {
    "Nose": (255, 0, 85, 255), "Neck": (255, 0, 0, 192),
    "RShoulder": (255, 85, 0, 255), "RElbow": (255, 170, 0, 255),
    "RWrist": (255, 255, 0, 255), "LShoulder": (170, 255, 0, 255),
    "LElbow": (85, 255, 0, 255), "LWrist": (0, 255, 0, 255),
    "MidHip": (255, 0, 0, 255), "RHip": (0, 255, 85, 255),
    "RKnee": (0, 255, 170, 255), "RAnkle": (0, 255, 255, 255),
    "LHip": (0, 170, 255, 255), "LKnee": (0, 85, 255, 255),
    "LAnkle": (0, 0, 255, 255), "REye": (255, 0, 170, 255),
    "LEye": (170, 0, 255, 255), "REar": (255, 0, 255, 255),
    "LEar": (85, 0, 255, 255),
    "LBigToe": (0, 0, 255, 255), "LSmallToe": (0, 0, 255, 255),
    "LHeel": (0, 0, 255, 255), "RBigToe": (0, 255, 255, 255),
    "RSmallToe": (0, 255, 255, 255), "RHeel": (0, 255, 255, 255),
}

_BODY_25_JOINTS = (
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle",
    "REye", "LEye", "REar", "LEar", "LBigToe", "LSmallToe", "LHeel",
    "RBigToe", "RSmallToe", "RHeel",
)

BODY_25_SKELETON = make_skeleton(
    "BODY_25_SKELETON",
    joints=_BODY_25_JOINTS,
    edges=[
        ("Nose", "Neck"), ("Neck", "RShoulder"), ("Neck", "LShoulder"),
        ("RShoulder", "RElbow"), ("RElbow", "RWrist"),
        ("LShoulder", "LElbow"), ("LElbow", "LWrist"),
        ("Neck", "MidHip"), ("MidHip", "RHip"), ("RHip", "RKnee"),
        ("RKnee", "RAnkle"), ("MidHip", "LHip"), ("LHip", "LKnee"),
        ("LKnee", "LAnkle"), ("Nose", "REye"), ("REye", "REar"),
        ("Nose", "LEye"), ("LEye", "LEar"), ("LAnkle", "LHeel"),
        ("RAnkle", "RHeel"), ("LAnkle", "LBigToe"), ("LBigToe", "LSmallToe"),
        ("LAnkle", "LSmallToe"), ("RAnkle", "RBigToe"),
        ("RBigToe", "RSmallToe"), ("RAnkle", "RSmallToe"),
    ],
    hips=["MidHip"], neck=["Neck"],
    colors=_OP_COLORS,
    flip_map=lr_flip_map(_BODY_25_JOINTS),
)

_COCO_JOINTS = (
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle",
    "REye", "LEye", "REar", "LEar",
)

COCO_SKELETON = make_skeleton(
    "COCO_SKELETON",
    joints=_COCO_JOINTS,
    edges=[
        ("Neck", "Nose"), ("Neck", "RShoulder"), ("Neck", "LShoulder"),
        ("RShoulder", "RElbow"), ("RElbow", "RWrist"),
        ("LShoulder", "LElbow"), ("LElbow", "LWrist"),
        ("Neck", "RHip"), ("RHip", "RKnee"), ("RKnee", "RAnkle"),
        ("Neck", "LHip"), ("LHip", "LKnee"), ("LKnee", "LAnkle"),
        ("Nose", "REye"), ("REye", "REar"), ("Nose", "LEye"), ("LEye", "LEar"),
    ],
    hips=["LHip", "RHip"], neck=["Neck"],
    colors=_OP_COLORS,
    flip_map=lr_flip_map(_COCO_JOINTS),
)

# CARLA bone name -> BODY_25 joint name correspondences
_BODY_25_MAPPING = {
    "crl_hips__C": "MidHip", "crl_arm__L": "LShoulder",
    "crl_foreArm__L": "LElbow", "crl_hand__L": "LWrist",
    "crl_neck__C": "Neck", "crl_Head__C": "Nose",
    "crl_arm__R": "RShoulder", "crl_foreArm__R": "RElbow",
    "crl_hand__R": "RWrist", "crl_eye__L": "LEye", "crl_eye__R": "REye",
    "crl_thigh__R": "RHip", "crl_leg__R": "RKnee", "crl_foot__R": "RAnkle",
    "crl_toe__R": "RBigToe", "crl_toeEnd__R": "RSmallToe",
    "crl_thigh__L": "LHip", "crl_leg__L": "LKnee", "crl_foot__L": "LAnkle",
    "crl_toe__L": "LBigToe", "crl_toeEnd__L": "LSmallToe",
}

_COCO_MAPPING = {c: j for c, j in _BODY_25_MAPPING.items()
                 if j in COCO_SKELETON.__members__ and c != "crl_hips__C"
                 and not c.startswith("crl_toe")}

register_skeleton("BODY_25_SKELETON", BODY_25_SKELETON, [
    (CARLA_SKELETON[c], BODY_25_SKELETON[j]) for c, j in _BODY_25_MAPPING.items()
])
register_skeleton("COCO_SKELETON", COCO_SKELETON, [
    (CARLA_SKELETON[c], COCO_SKELETON[j]) for c, j in _COCO_MAPPING.items()
])
