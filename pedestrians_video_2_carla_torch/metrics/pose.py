"""Pose metrics: MPJPE, MRPE, PCK, MissingJointsRatio and the MSE of a
prediction key (the JAX package's ``metrics/pose.py``), as additive states
of tensors on the device."""
from typing import Type

import torch

from ..ops.kinematics import world_from_changes
from ..ops.normalization import hips_neck_shift_scale
from ..ops.tensors import get_bboxes, get_missing_joints_mask
from ..skeletons.base import (Skeleton, common_hips_index,
                              get_common_indices)
from ..skeletons.carla import CARLA_SKELETON
from .base import Metric, safe_div


def _errors_state(device):
    return {"errors": torch.zeros((), device=device),
            "total": torch.zeros((), dtype=torch.int64, device=device)}


class MPJPE(Metric):
    """Mean Per Joint Position Error in mm: each clip's mean over joints
    and frames, then the mean over clips."""

    def __init__(self, input_nodes: Type[Skeleton] = CARLA_SKELETON,
                 output_nodes: Type[Skeleton] = CARLA_SKELETON):
        self.output_indices, self.input_indices = get_common_indices(
            input_nodes, output_nodes)

    def init_state(self, device=None):
        return _errors_state(device)

    def update(self, state, preds, targets):
        if preds.get("absolute_pose_loc") is None \
                or targets.get("absolute_pose_loc") is None:
            return state
        pred = preds["absolute_pose_loc"][:, :, self.output_indices]
        gt = targets["absolute_pose_loc"][:, :, self.input_indices]
        per_clip = torch.linalg.norm(pred - gt, dim=-1).mean(dim=(-2, -1))
        return {"errors": state["errors"] + per_clip.sum(),
                "total": state["total"] + per_clip.numel()}

    def compute(self, state):
        return 1000.0 * safe_div(state["errors"], state["total"])


class MRPE(Metric):
    """Mean Root (hips) Position Error in mm, the world track included."""

    def __init__(self, input_nodes: Type[Skeleton] = CARLA_SKELETON,
                 output_nodes: Type[Skeleton] = CARLA_SKELETON):
        self.input_nodes = input_nodes
        self.output_nodes = output_nodes

    def init_state(self, device=None):
        return _errors_state(device)

    def update(self, state, preds, targets):
        if preds.get("absolute_pose_loc") is None \
                or targets.get("absolute_pose_loc") is None \
                or targets.get("world_loc_changes") is None:
            return state
        pred_pose = preds["absolute_pose_loc"]
        target_pose = targets["absolute_pose_loc"]
        B, L = pred_pose.shape[:2]

        if preds.get("world_loc_changes") is not None:
            pred_world, _ = world_from_changes(
                (B, L), preds["world_loc_changes"])
        elif preds.get("world_loc") is not None:
            pred_world = preds["world_loc"]
        else:
            pred_world = pred_pose.new_zeros((B, L, 3))
        target_world, _ = world_from_changes(
            (B, L), targets["world_loc_changes"])

        pred_hips = hips_neck_shift_scale(pred_pose, self.output_nodes).shift
        target_hips = hips_neck_shift_scale(target_pose,
                                            self.input_nodes).shift

        err = torch.linalg.norm(
            (pred_world + pred_hips) - (target_world + target_hips), dim=-1)
        per_clip = err.mean(dim=-1)
        return {"errors": state["errors"] + per_clip.sum(),
                "total": state["total"] + per_clip.numel()}

    def compute(self, state):
        return 1000.0 * safe_div(state["errors"], state["total"])


class PCK(Metric):
    """Percentage of Correct Keypoints: the share of present joints within
    ``threshold`` of the ground truth, in units of a per-frame distance
    ('hn': hips to neck, 'bbox': the bounding box's diagonal)."""

    def __init__(self, input_nodes: Type[Skeleton] = CARLA_SKELETON,
                 output_nodes: Type[Skeleton] = CARLA_SKELETON,
                 mask_missing_joints: bool = True,
                 key: str = "projection_2d",
                 threshold: float = 0.05,
                 normalization: str = "bbox",
                 near_zero: float = 1e-5):
        self.input_nodes = input_nodes
        self.output_indices, self.input_indices = get_common_indices(
            input_nodes, output_nodes)
        self.key = key
        self.threshold = threshold
        self.normalization = normalization
        self.mask_missing_joints = mask_missing_joints
        self.near_zero = near_zero
        self._hips = common_hips_index(input_nodes, self.input_indices)

    def _norm_dist(self, sample):
        if self.normalization == "hn":
            return hips_neck_shift_scale(sample, self.input_nodes).scale
        bboxes = get_bboxes(sample)
        return torch.linalg.norm(bboxes[..., 1, :] - bboxes[..., 0, :],
                                 dim=-1)

    def init_state(self, device=None):
        return {"correct": torch.zeros((), dtype=torch.int64, device=device),
                "total": torch.zeros((), dtype=torch.int64, device=device)}

    def distances(self, preds, targets):
        """-> (the normalized distances, the mask of the joints counted),
        each (B, L, J)."""
        pred = preds[self.key][:, :, self.output_indices, :2]
        gt = targets[self.key][:, :, self.input_indices, :2]
        if self.mask_missing_joints \
                and targets.get("projection_2d") is not None:
            raw = targets["projection_2d"][:, :, self.input_indices]
            mask = get_missing_joints_mask(raw, self._hips)
        else:
            mask = torch.ones(gt.shape[:-1], dtype=torch.bool,
                              device=gt.device)
        normalize = self._norm_dist(targets[self.key][..., :2])
        mask = mask & (normalize >= self.near_zero)[..., None]
        normalize = torch.where(normalize < self.near_zero,
                                torch.ones_like(normalize), normalize)
        norm_dist = torch.linalg.norm(pred - gt, dim=-1) \
            / normalize[..., None]
        return norm_dist, mask

    def update(self, state, preds, targets):
        if preds.get(self.key) is None or targets.get(self.key) is None:
            return state
        norm_dist, mask = self.distances(preds, targets)
        correct = ((norm_dist < self.threshold) & mask).sum()
        return {"correct": state["correct"] + correct,
                "total": state["total"] + mask.sum()}

    def compute(self, state):
        return safe_div(state["correct"].to(torch.float32), state["total"])


class MissingJointsRatio(Metric):
    """The share of missing (exact-zero) joints in the 2D predictions,
    optionally per joint."""

    def __init__(self, input_nodes: Type[Skeleton] = CARLA_SKELETON,
                 output_nodes: Type[Skeleton] = CARLA_SKELETON,
                 report_per_joint: bool = False):
        self.output_indices, self.input_indices = get_common_indices(
            input_nodes, output_nodes)
        if isinstance(self.output_indices, slice):
            self.num_joints = len(output_nodes)
        else:
            self.num_joints = len(self.output_indices)
        self.report_per_joint = report_per_joint

    def init_state(self, device=None):
        return {"present": torch.zeros((self.num_joints,), device=device),
                "total": torch.zeros((), dtype=torch.int64, device=device)}

    def update(self, state, preds, targets):
        if preds.get("projection_2d") is None:
            return state
        pred = preds["projection_2d"][:, :, self.output_indices]
        present = torch.all(pred != 0, dim=-1)
        count = present.numel() // self.num_joints
        return {"present": state["present"] + present.sum(
            dim=tuple(range(present.ndim - 1))),
            "total": state["total"] + count}

    def compute(self, state):
        ratio = 1.0 - safe_div(state["present"], state["total"])
        if self.report_per_joint:
            return {"overall": ratio.mean(),
                    **{str(i): ratio[i] for i in range(self.num_joints)}}
        return ratio.mean()


class MultiinputMSE(Metric):
    """MSE between ``preds[key]`` and ``targets[key]`` over the common
    joints, without the missing ones."""

    def __init__(self, key: str = "projection_2d_transformed",
                 input_nodes: Type[Skeleton] = CARLA_SKELETON,
                 output_nodes: Type[Skeleton] = CARLA_SKELETON,
                 mask_missing_joints: bool = True):
        self.key = key
        self.output_indices, self.input_indices = get_common_indices(
            input_nodes, output_nodes)
        self.mask_missing_joints = mask_missing_joints
        self._hips = common_hips_index(input_nodes, self.input_indices)

    def init_state(self, device=None):
        return {"sq": torch.zeros((), device=device),
                "n": torch.zeros((), dtype=torch.int64, device=device)}

    def update(self, state, preds, targets):
        if preds.get(self.key) is None or targets.get(self.key) is None:
            return state
        pred = preds[self.key][..., self.output_indices, :2]
        gt = targets[self.key][..., self.input_indices, :2]
        if self.mask_missing_joints:
            mask = get_missing_joints_mask(gt, self._hips)[..., None]
            sq = (((pred - gt) ** 2) * mask).sum()
            n = mask.sum() * pred.shape[-1]
        else:
            sq = ((pred - gt) ** 2).sum()
            n = pred.numel()
        return {"sq": state["sq"] + sq, "n": state["n"] + n}

    def compute(self, state):
        return safe_div(state["sq"], state["n"])
