"""The SMPL(-X) body model's joint and vertex paths, on tensors.

Posed joints (``joint_locations``) are the rest joints regressed from the
template mesh, moved by rigid forward kinematics of the axis-angle bone
rotations over the kinematic tree. Posed vertices (``vertex_locations``)
are linear-blend skinned from those joint transforms (SMPL's LBS without
pose or shape blendshapes, enough for the renderer's frames). Both run on
the device of the pose tensor they are given.

The model is a standard SMPL / SMPL-X ``model.npz`` (``v_template``,
``J_regressor``, ``kintree_table``, and ``weights`` and ``f`` for the
mesh). Such files are licensed and not shipped: a user puts them under
``models/smpl-x/smplx_locked_head/<gender>/model.npz``, and
``load_body_model_npz`` raises ``FileNotFoundError`` naming that place
when a file is missing.
"""
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ...ops.kinematics import forward_kinematics
from ...ops.rotations import axis_angle_to_matrix

SMPL_BODY_MODEL_DIR = os.path.join("models", "smpl-x", "smplx_locked_head")
SMPL_MODELS = {g: os.path.join(g, "model.npz")
               for g in ("male", "female", "neutral")}


@dataclass(frozen=True)
class BodyModelData:
    rest_joints: np.ndarray   # (J, 3) float32 regressed rest-pose joints
    parents: Tuple[int, ...]  # the kinematic tree, -1 at the root
    #: the mesh, for the skinned vertices (None where the file has none)
    v_template: Optional[np.ndarray] = None    # (V, 3) float32
    skin_weights: Optional[np.ndarray] = None  # (V, J) float32
    faces: Optional[np.ndarray] = None         # (F, 3) int64 vertex indices


def load_body_model_npz(path: str, num_joints: Optional[int] = None
                        ) -> BodyModelData:
    """The body model of a ``model.npz``, its tree cut to the first
    ``num_joints`` joints where given: the skin weights of each cut joint
    go to its nearest kept ancestor."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"SMPL body model not found at {path}. Download the SMPL-X "
            "locked-head models and place them under "
            f"{SMPL_BODY_MODEL_DIR}/<gender>/model.npz")
    with np.load(path, allow_pickle=True) as data:
        v_template = np.asarray(data["v_template"], dtype=np.float64)
        j_regressor = np.asarray(data["J_regressor"], dtype=np.float64)
        kintree = np.asarray(data["kintree_table"], dtype=np.int64)
        weights = np.asarray(data["weights"], dtype=np.float32) \
            if "weights" in data else None
        faces = np.asarray(data["f"], dtype=np.int64) \
            if "f" in data else None
    joints = j_regressor @ v_template
    parents = kintree[0].copy()
    parents[0] = -1
    if num_joints is not None:
        joints = joints[:num_joints]
        parents = parents[:num_joints]
        if weights is not None:
            w = weights.copy()
            for j in range(weights.shape[1] - 1, num_joints - 1, -1):
                anc = int(kintree[0, j])
                while anc >= num_joints:
                    anc = int(kintree[0, anc])
                w[:, anc] += w[:, j]
            weights = w[:, :num_joints]
    return BodyModelData(rest_joints=joints.astype(np.float32),
                         parents=tuple(int(p) for p in parents),
                         v_template=v_template.astype(np.float32),
                         skin_weights=weights, faces=faces)


@lru_cache(maxsize=8)
def get_body_model(gender: str = "neutral",
                   body_model_dir: str = SMPL_BODY_MODEL_DIR,
                   num_joints: Optional[int] = 22) -> BodyModelData:
    """The body model of ``gender``, cached, cut to ``num_joints`` joints
    (22 by default: the pelvis and the 21 body joints that AMASS's body
    pose drives; SMPL has 24 joints and SMPL-X 55)."""
    return load_body_model_npz(
        os.path.join(body_model_dir, SMPL_MODELS[gender]),
        num_joints=num_joints)


def _posed_joints(model: BodyModelData, pose_body: torch.Tensor,
                  root_orient: Optional[torch.Tensor]):
    """(posed joints (..., J, 3), their absolute rotations (..., J, 3, 3),
    the rest joints (J, 3)) of a pose, on its device."""
    pose_body = torch.as_tensor(pose_body)
    J = len(model.parents)
    pose_body = pose_body.reshape(tuple(pose_body.shape[:-1]) + (J - 1, 3))
    if root_orient is None:
        root_orient = pose_body.new_zeros(tuple(pose_body.shape[:-2]) + (3,))
    full_pose = torch.cat([torch.as_tensor(root_orient)[..., None, :],
                           pose_body], dim=-2)
    # Rodrigues gives column-vector matrices, the FK composes row-vector
    # ones (v' = v @ R)
    rot = axis_angle_to_matrix(full_pose).transpose(-1, -2)
    parents = np.asarray(model.parents)
    rest = torch.as_tensor(model.rest_joints, device=pose_body.device)
    has_parent = torch.as_tensor((parents >= 0)[:, None],
                                 device=pose_body.device)
    # pelvis-relative bone offsets (the root's is zero; the pelvis is added
    # back at the end)
    rel_loc = torch.where(has_parent,
                          rest - rest[np.maximum(parents, 0)],
                          torch.zeros((), device=pose_body.device))
    rel_loc = rel_loc.expand(tuple(rot.shape[:-2]) + (3,))
    abs_loc, abs_rot = forward_kinematics(rel_loc, rot,
                                          parents=model.parents)
    return abs_loc + rest[0], abs_rot, rest


def joint_locations(model: BodyModelData, pose_body: torch.Tensor,
                    root_orient: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Posed joint locations.

    :param pose_body: (..., (J-1)*3) axis-angle body pose, root excluded.
    :param root_orient: (..., 3) axis-angle root orientation (zero if None).
    :return: (..., J, 3) joint locations in SMPL world coordinates, on the
        pose's device.
    """
    return _posed_joints(model, pose_body, root_orient)[0]


def vertex_locations(model: BodyModelData, pose_body: torch.Tensor,
                     root_orient: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Linear-blend-skinned mesh vertices: each vertex moved rigidly with
    every joint, ``(v - rest_j) @ R_j + posed_j``, and the moves blended
    by its skin weights.

    :param pose_body: (..., (J-1)*3) axis-angle body pose, root excluded.
    :return: (..., V, 3) posed vertices in SMPL world coordinates, on the
        pose's device.
    """
    if model.v_template is None or model.skin_weights is None:
        raise ValueError("body model was loaded without mesh data "
                         "(v_template/weights)")
    posed, abs_rot, rest = _posed_joints(model, pose_body, root_orient)
    device = posed.device
    v = torch.as_tensor(model.v_template, device=device)        # (V, 3)
    w = torch.as_tensor(model.skin_weights, device=device)      # (V, J)
    out = None
    # one joint at a time, in elementwise float32 (no matmul, so no TF32 on
    # the card), without the (..., V, J, 3) product in memory
    for j in range(len(model.parents)):
        local = v - rest[j]                                      # (V, 3)
        r = abs_rot[..., j, None, :, :]                          # (..., 1, 3, 3)
        moved = (local[:, 0, None] * r[..., 0, :]
                 + local[:, 1, None] * r[..., 1, :]
                 + local[:, 2, None] * r[..., 2, :]
                 + posed[..., j, None, :])
        term = w[:, j, None] * moved
        out = term if out is None else out + term
    return out
