"""Base flow: model bundle + loss chain + the train and eval steps.

A flow owns its ``nn.Module`` models and its loss and optimizer
configuration, and applies the models functionally
(``torch.func.functional_call``) to an explicit parameter dict
``{"movements": state_dict, "trajectory": state_dict}``. The parameters come
from the models' own seeded init (:meth:`BaseFlow.init_params`) or from the
flax weight bridge (``models/jax_import.py``). Training carries them in a
:class:`FlowState` with their AdamW optimizer and the step count.
"""
import inspect
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.func import functional_call

from ..losses import (LossContext, LossModes, calculate_losses, primary_loss,
                      resolve_loss_modes)
from ..models.base import OptimizerSettings, make_adamw
from ..models.trajectory.zero import ZeroTrajectory
from ..utils.device import DeviceLike, resolve_device
from .output_types import MovementsModelOutputType

Params = Dict[str, Dict[str, torch.Tensor]]

DEFAULT_SEED = 22742


@dataclass
class FlowState:
    """What training carries from step to step: the parameter dict (leaves
    that require grad), the AdamW optimizer over those leaves, and the
    number of steps taken. ``training_step`` updates it in place."""
    params: Params
    optimizer: torch.optim.Optimizer
    step: int = 0


class BaseFlow:
    """Common flow machinery. Subclasses define ``_inner_step``."""

    def __init__(self,
                 movements_model: torch.nn.Module,
                 trajectory_model: Optional[torch.nn.Module] = None,
                 loss_modes: Optional[List] = None,
                 mask_missing_joints: bool = True,
                 movements_optimizer: Optional[OptimizerSettings] = None,
                 trajectory_optimizer: Optional[OptimizerSettings] = None,
                 transform: str = "hips_neck",
                 precision: str = "32",
                 gradient_clip_val: float = 0.0,
                 projection_kernel: str = "plain",
                 seed: int = DEFAULT_SEED,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if str(precision) in ("16", "bf16"):
            raise NotImplementedError(
                "the port runs in float32 only; bf16 is not ported yet")
        if str(precision) != "32":
            raise ValueError(f"unknown precision {precision!r}")
        if gradient_clip_val and gradient_clip_val > 0:
            raise NotImplementedError(
                "gradient clipping is not ported yet (see ROADMAP.md)")
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
        self.movements_optimizer = movements_optimizer or OptimizerSettings()
        self.trajectory_optimizer = trajectory_optimizer or OptimizerSettings()
        self.transform = transform
        #: "plain" (PyTorch ops), "fused" (the serving CUDA kernel) or
        #: "fused_train" (the training CUDA kernels, forward and backward)
        #: for the pose_changes path -- see ops/projection.py
        self.projection_kernel = projection_kernel
        self.outputs_key = "projection_2d" if transform in (None, "none") \
            else "projection_2d_transformed"
        #: draws the dropout masks of the training steps, on the flow's
        #: device, for the models whose forward takes a ``generator``
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._takes_generator = [
            m for m in (self.movements_model, self.trajectory_model)
            if "generator" in inspect.signature(m.forward).parameters]

    # -- parameters --------------------------------------------------------
    def init_params(self) -> Params:
        """The models' current (seeded-init) parameters, on the flow's
        device, as the parameter dict the steps take."""
        return {"movements": {k: v.detach() for k, v in
                              self.movements_model.state_dict().items()},
                "trajectory": {k: v.detach() for k, v in
                               self.trajectory_model.state_dict().items()}}

    # -- state -------------------------------------------------------------
    def init_state(self, params: Optional[Params] = None) -> FlowState:
        """A training state over copies of ``params`` (default: the models'
        own seeded init): one AdamW over both models, a parameter group per
        model with its own settings, as the JAX package's per-model
        ``optax.multi_transform``."""
        params = self.init_params() if params is None else params
        params = {name: {k: v.detach().to(self.device).clone()
                         .requires_grad_(True) for k, v in tree.items()}
                  for name, tree in params.items()}
        optimizer = make_adamw({
            "movements": (self.movements_optimizer,
                          params["movements"].values()),
            "trajectory": (self.trajectory_optimizer,
                           params["trajectory"].values())})
        return FlowState(params=params, optimizer=optimizer, step=0)

    @staticmethod
    def current_lrs(state: FlowState) -> Dict[str, float]:
        """Per-model learning rates, for step logging."""
        return {f"lr-{group['name']}": group["lr"]
                for group in state.optimizer.param_groups}

    @staticmethod
    def param_counts(state: FlowState) -> Dict[str, int]:
        """Per-model parameter counts."""
        return {name: sum(v.numel() for v in tree.values())
                for name, tree in state.params.items()}

    # -- model application -------------------------------------------------
    def _apply_model(self, model, params, inputs, targets, training: bool):
        kwargs = {"training": training}
        if training and any(model is m for m in self._takes_generator):
            kwargs["generator"] = self.generator
        return functional_call(model, params, (inputs, targets), kwargs)

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
    def training_step(self, state: FlowState, batch
                      ) -> Tuple[FlowState, Dict[str, torch.Tensor]]:
        """One AdamW step on ``batch``, in place: forward, losses, the
        primary loss's backward, the optimizer step, ``step += 1``. Returns
        the state and the logs ``train_loss/<mode>`` and
        ``train_loss/primary``, as tensors on the device (reading them
        synchronises with the card). The gradients stay in the parameters'
        ``.grad`` until the next step."""
        sliced = self._inner_step(state.params, batch, training=True)
        loss_dict = self._compute_losses(sliced, sliced["targets"])
        _, primary = primary_loss(loss_dict, self.requested_loss_modes)
        state.optimizer.zero_grad(set_to_none=True)
        primary.backward()
        state.optimizer.step()
        state.step += 1
        logs = {f"train_loss/{k}": v.detach() for k, v in loss_dict.items()}
        logs["train_loss/primary"] = primary.detach()
        return state, logs

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
