"""Base flow: model bundle + loss chain + the eval step.

A flow owns its ``nn.Module`` models and its loss configuration, and
applies the models functionally (``torch.func.functional_call``) to an
explicit parameter dict ``{"movements": state_dict, "trajectory":
state_dict}``. The parameters come from the models' own seeded init
(:meth:`BaseFlow.init_params`) or from the flax weight bridge
(``models/jax_import.py``). The training step, the optimizer and its state
are not ported yet.
"""
from typing import Any, Dict, List, Optional

import torch
from torch.func import functional_call

from ..losses import (LossContext, LossModes, calculate_losses,
                      resolve_loss_modes)
from ..models.trajectory.zero import ZeroTrajectory
from ..utils.device import DeviceLike, resolve_device
from .output_types import MovementsModelOutputType

Params = Dict[str, Dict[str, torch.Tensor]]


class BaseFlow:
    """Common flow machinery. Subclasses define ``_inner_step``."""

    def __init__(self,
                 movements_model: torch.nn.Module,
                 trajectory_model: Optional[torch.nn.Module] = None,
                 loss_modes: Optional[List] = None,
                 mask_missing_joints: bool = True,
                 transform: str = "hips_neck",
                 precision: str = "32",
                 projection_kernel: str = "plain",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if str(precision) in ("16", "bf16"):
            raise NotImplementedError(
                "the port runs in float32 only; bf16 is not ported yet")
        if str(precision) != "32":
            raise ValueError(f"unknown precision {precision!r}")
        self.movements_model = movements_model.to(self.device)
        self.trajectory_model = (trajectory_model if trajectory_model
                                 is not None else ZeroTrajectory()
                                 ).to(self.device)
        self.mask_missing_joints = mask_missing_joints

        if not loss_modes:
            loss_modes = [LossModes.loc_2d]
        self.requested_loss_modes = [
            LossModes[m] if isinstance(m, str) else m for m in loss_modes]
        self.losses_to_calculate = resolve_loss_modes(self.requested_loss_modes)
        self.transform = transform
        #: "plain" (PyTorch ops) or "fused" (the CUDA kernel for the
        #: forward-only pose_changes path) -- see ops/projection.py
        self.projection_kernel = projection_kernel

    # -- parameters --------------------------------------------------------
    def init_params(self) -> Params:
        """The models' current (seeded-init) parameters, on the flow's
        device, as the parameter dict the steps take."""
        return {"movements": {k: v.detach() for k, v in
                              self.movements_model.state_dict().items()},
                "trajectory": {k: v.detach() for k, v in
                               self.trajectory_model.state_dict().items()}}

    # -- model application -------------------------------------------------
    def _apply_model(self, model, params, inputs, targets, training: bool):
        return functional_call(model, params, (inputs, targets),
                               {"training": training})

    def _inner_step(self, params: Params, batch, training: bool):
        """-> sliced dict. Flow-specific."""
        raise NotImplementedError

    # -- losses ------------------------------------------------------------
    def _compute_losses(self, sliced, targets) -> Dict[str, torch.Tensor]:
        ctx = LossContext(
            input_nodes=self.movements_model.input_nodes,
            output_nodes=self.movements_model.output_nodes,
            sliced=sliced, targets=targets,
            mask_missing_joints=self.mask_missing_joints,
        )
        return calculate_losses(
            self.losses_to_calculate, self.requested_loss_modes, ctx)

    # -- steps -------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, params: Params, batch):
        """-> (loss dict, preds, targets) for metric accumulation."""
        sliced = self._inner_step(params, batch, training=False)
        loss_dict = self._compute_losses(sliced, sliced["targets"])
        preds = self._metric_preds(sliced)
        return loss_dict, preds, sliced["targets"]

    def _metric_preds(self, sliced) -> Dict[str, Any]:
        """Preds dict for metrics."""
        preds = {
            "pose_changes": sliced.get("pose_inputs")
            if self.movements_model.output_type
            == MovementsModelOutputType.pose_changes else None,
            "world_loc_changes": None,
            "world_rot_changes": None,
        }
        for k in ("projection_2d", "projection_2d_transformed",
                  "absolute_pose_loc", "absolute_pose_rot",
                  "world_loc", "world_rot", "relative_pose_loc",
                  "relative_pose_rot"):
            if k in sliced:
                preds[k] = sliced[k]
        return preds
