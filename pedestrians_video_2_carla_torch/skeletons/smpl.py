"""SMPL skeleton: the 22 body joints of SMPL, re-indexed into an order
that follows the CARLA skeleton's depth-first layout, with the tables that
map to and from the original SMPL joint order and the mapping to CARLA."""
import numpy as np
import torch

from .base import register_skeleton
from .carla import CARLA_SKELETON
from .factory import make_skeleton

#: original SMPL joint order (meshcapade SMPL family, first 22 joints)
ORIG_SMPL_JOINTS = (
    "Pelvis", "L_Hip", "R_Hip", "Spine1", "L_Knee", "R_Knee", "Spine2",
    "L_Ankle", "R_Ankle", "Spine3", "L_Foot", "R_Foot", "Neck", "L_Collar",
    "R_Collar", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist",
)

#: re-indexed order used by this package's tensors (torso->left arm->head->
#: right arm->right leg->left leg, mirroring the CARLA DFS layout)
_SMPL_JOINTS = (
    "Pelvis", "Spine1", "Spine2", "Spine3", "L_Collar", "L_Shoulder",
    "L_Elbow", "L_Wrist", "Neck", "Head", "R_Collar", "R_Shoulder",
    "R_Elbow", "R_Wrist", "R_Hip", "R_Knee", "R_Ankle", "R_Foot",
    "L_Hip", "L_Knee", "L_Ankle", "L_Foot",
)

_SMPL_COLORS = {
    "Pelvis": (255, 0, 0, 192), "Spine1": (255, 0, 0, 128),
    "Spine2": (255, 0, 0, 128), "Spine3": (255, 0, 0, 128),
    "L_Collar": (170, 255, 0, 128), "L_Shoulder": (170, 255, 0, 255),
    "L_Elbow": (85, 255, 0, 255), "L_Wrist": (0, 255, 0, 255),
    "Neck": (255, 0, 0, 192), "Head": (255, 0, 85, 255),
    "R_Collar": (255, 85, 0, 128), "R_Shoulder": (255, 85, 0, 255),
    "R_Elbow": (255, 170, 0, 255), "R_Wrist": (255, 255, 0, 255),
    "R_Hip": (0, 255, 85, 255), "R_Knee": (0, 255, 170, 255),
    "R_Ankle": (0, 255, 255, 255), "R_Foot": (0, 255, 255, 255),
    "L_Hip": (0, 170, 255, 255), "L_Knee": (0, 85, 255, 255),
    "L_Ankle": (0, 0, 255, 255), "L_Foot": (0, 0, 255, 255),
}

SMPL_SKELETON = make_skeleton(
    "SMPL_SKELETON",
    joints=_SMPL_JOINTS,
    edges=[
        ("Pelvis", "Spine1"), ("Spine1", "Spine2"), ("Spine2", "Spine3"),
        ("Spine3", "L_Collar"), ("L_Collar", "L_Shoulder"),
        ("L_Shoulder", "L_Elbow"), ("L_Elbow", "L_Wrist"),
        ("Spine3", "Neck"), ("Neck", "Head"),
        ("Spine3", "R_Collar"), ("R_Collar", "R_Shoulder"),
        ("R_Shoulder", "R_Elbow"), ("R_Elbow", "R_Wrist"),
        ("Pelvis", "R_Hip"), ("R_Hip", "R_Knee"), ("R_Knee", "R_Ankle"),
        ("R_Ankle", "R_Foot"),
        ("Pelvis", "L_Hip"), ("L_Hip", "L_Knee"), ("L_Knee", "L_Ankle"),
        ("L_Ankle", "L_Foot"),
    ],
    hips=["Pelvis"], neck=["Neck"],
    colors=_SMPL_COLORS,
    flip_map={j: "R" + j[1:] for j in _SMPL_JOINTS if j.startswith("L_")},
)

SMPL_SKELETON.get_root_point = classmethod(lambda cls: SMPL_SKELETON.Pelvis)

#: gather index arrays between the orderings
FROM_ORIG_INDICES = np.asarray(
    [ORIG_SMPL_JOINTS.index(j) for j in _SMPL_JOINTS], dtype=np.int64)
TO_ORIG_INDICES = np.asarray(
    [_SMPL_JOINTS.index(j) for j in ORIG_SMPL_JOINTS], dtype=np.int64)


def _take(t, indices: np.ndarray):
    """``t[..., indices, :]`` of a numpy array or a tensor (on its device)."""
    if isinstance(t, torch.Tensor):
        return t.index_select(-2, torch.as_tensor(indices, device=t.device))
    return np.asarray(t)[..., indices, :]


def map_from_original(tensor):
    """(..., 22*3) or (..., 22, 3) in the original SMPL order -> (..., 22, 3)
    re-indexed; a numpy array stays one, a tensor stays on its device."""
    t = tensor if isinstance(tensor, torch.Tensor) else np.asarray(tensor)
    if t.shape[-1] != 3:
        t = t.reshape(tuple(t.shape[:-1]) + (len(_SMPL_JOINTS), 3))
    return _take(t, FROM_ORIG_INDICES)


def map_to_original(tensor, reshape: bool = True):
    """(..., 22, 3) re-indexed -> the original SMPL order, flattened to
    (..., 66) unless ``reshape`` is false."""
    t = _take(tensor, TO_ORIG_INDICES)
    return t.reshape(tuple(t.shape[:-2]) + (-1,)) if reshape else t


register_skeleton("SMPL_SKELETON", SMPL_SKELETON, [
    (CARLA_SKELETON[c], SMPL_SKELETON[j]) for c, j in {
        "crl_hips__C": "Pelvis", "crl_spine__C": "Spine1",
        "crl_spine01__C": "Spine3", "crl_shoulder__L": "L_Collar",
        "crl_arm__L": "L_Shoulder", "crl_foreArm__L": "L_Elbow",
        "crl_hand__L": "L_Wrist", "crl_neck__C": "Neck",
        "crl_Head__C": "Head", "crl_shoulder__R": "R_Collar",
        "crl_arm__R": "R_Shoulder", "crl_foreArm__R": "R_Elbow",
        "crl_hand__R": "R_Wrist", "crl_thigh__R": "R_Hip",
        "crl_leg__R": "R_Knee", "crl_foot__R": "R_Ankle",
        "crl_toe__R": "R_Foot", "crl_thigh__L": "L_Hip",
        "crl_leg__L": "L_Knee", "crl_foot__L": "L_Ankle",
        "crl_toe__L": "L_Foot",
    }.items()
])
