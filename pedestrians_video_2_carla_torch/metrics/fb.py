"""The FB_* metric family: VideoPose3D's error functions (MPJPE, weighted,
scale-normalized, Procrustes-aligned and velocity) as additive-state
metrics over the absolute 3D pose (the JAX package's ``metrics/fb.py``).
All values in mm."""
from typing import Dict

import torch

from .base import Metric, safe_div


def fb_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean euclidean distance per joint: (N, J, 3) -> scalar."""
    return torch.linalg.norm(pred - gt, dim=-1).mean()


def fb_weighted_mpjpe(pred: torch.Tensor, gt: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    return (w * torch.linalg.norm(pred - gt, dim=-1)).mean()


def fb_n_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """MPJPE after the optimal per-sample scaling of the predictions."""
    norm_pred = (pred ** 2).sum(dim=-1, keepdim=True).mean(dim=-2,
                                                          keepdim=True)
    norm_gt = (gt * pred).sum(dim=-1, keepdim=True).mean(dim=-2,
                                                         keepdim=True)
    scale = norm_gt / torch.clamp(norm_pred, min=1e-12)
    return fb_mpjpe(scale * pred, gt)


def fb_p_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE: the optimal rigid alignment (rotation,
    scale, translation) of each (J, 3) sample before the error, from a
    3 x 3 SVD per sample."""
    mu_x = gt.mean(dim=1, keepdim=True)
    mu_y = pred.mean(dim=1, keepdim=True)
    x0 = gt - mu_x
    y0 = pred - mu_y
    norm_x = torch.sqrt((x0 ** 2).sum(dim=(1, 2), keepdim=True))
    norm_y = torch.sqrt((y0 ** 2).sum(dim=(1, 2), keepdim=True))
    x0 = x0 / torch.clamp(norm_x, min=1e-12)
    y0 = y0 / torch.clamp(norm_y, min=1e-12)

    h = torch.matmul(x0.transpose(-1, -2), y0)
    u, s, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    r = torch.matmul(v, u.transpose(-1, -2))
    # fix improper rotations (reflections)
    sign_det_r = torch.sign(torch.linalg.det(r)).unsqueeze(-1)
    v = torch.cat([v[:, :, :-1], v[:, :, -1:] * sign_det_r[:, None]],
                  dim=-1)
    s = torch.cat([s[:, :-1], s[:, -1:] * sign_det_r], dim=-1)
    r = torch.matmul(v, u.transpose(-1, -2))

    tr = s.sum(dim=1, keepdim=True).unsqueeze(-1)
    a = tr * norm_x / torch.clamp(norm_y, min=1e-12)
    t = mu_x - a * torch.matmul(mu_y, r)
    pred_aligned = a * torch.matmul(pred, r) + t
    return fb_mpjpe(pred_aligned, gt)


def fb_mean_velocity_error(pred: torch.Tensor,
                           gt: torch.Tensor) -> torch.Tensor:
    """MPJVE: the mean per-joint velocity error along the frame axis of
    (B, L, J, 3) clips."""
    v_pred = torch.diff(pred, dim=1)
    v_gt = torch.diff(gt, dim=1)
    return torch.linalg.norm(v_pred - v_gt, dim=-1).mean()


class _FBBase(Metric):
    needs_clip_shape = False

    def init_state(self, device=None):
        return {"errors": torch.zeros((), device=device),
                "total": torch.zeros((), dtype=torch.int64, device=device)}

    def _metric(self, pred, gt):
        raise NotImplementedError

    def update(self, state, preds: Dict, targets: Dict):
        pred = preds.get("absolute_pose_loc")
        gt = targets.get("absolute_pose_loc")
        if pred is None or gt is None or pred.shape != gt.shape:
            return state
        if not self.needs_clip_shape:
            pred = pred.reshape((-1,) + tuple(pred.shape[-2:]))
            gt = gt.reshape((-1,) + tuple(gt.shape[-2:]))
        frames = pred.shape[0] if not self.needs_clip_shape \
            else pred.shape[0] * pred.shape[1]
        value = self._metric(pred, gt)
        return {"errors": state["errors"] + frames * value,
                "total": state["total"] + frames}

    def compute(self, state):
        return 1000.0 * safe_div(state["errors"], state["total"])


class FB_MPJPE(_FBBase):
    def _metric(self, pred, gt):
        return fb_mpjpe(pred, gt)


class FB_WeightedMPJPE(_FBBase):
    def __init__(self, weights=None):
        self.weights = weights

    def _metric(self, pred, gt):
        w = self.weights if self.weights is not None \
            else torch.ones(pred.shape[:-1], dtype=pred.dtype,
                            device=pred.device)
        return fb_weighted_mpjpe(pred, gt, w)


class FB_N_MPJPE(_FBBase):
    def _metric(self, pred, gt):
        return fb_n_mpjpe(pred, gt)


class FB_PA_MPJPE(_FBBase):
    def _metric(self, pred, gt):
        return fb_p_mpjpe(pred, gt)


class FB_MPJVE(_FBBase):
    needs_clip_shape = True

    def _metric(self, pred, gt):
        return fb_mean_velocity_error(pred, gt)
