"""Base flow: model bundle + loss chain + metrics + the train and eval
steps.

A flow owns its ``nn.Module`` models and its loss and optimizer
configuration, and applies the models functionally
(``torch.func.functional_call``) to an explicit parameter dict
``{"movements": state_dict, "trajectory": state_dict}``. The parameters come
from the models' own seeded init (:meth:`BaseFlow.init_params`) or from the
flax weight bridge (``models/jax_import.py``). A model's persistent buffers
(BatchNorm's running statistics, the JAX package's ``mutables``) sit in the
same dict beside its parameters: ``functional_call`` receives both, a
training step updates the buffers in place, and evaluation and serving
read them. Training carries the dict in a :class:`FlowState` with the
AdamW optimizer of its parameters, the LR schedules and the step count;
the buffers are no grad leaves (:func:`state_params`), so AdamW, the
clip, ``param_counts`` and the trainer's anomaly check never see them. An
update clips the gradients by their global norm over every model
(``gradient_clip_val``), sets each schedule's lr and steps AdamW, as the
JAX package's ``clip_by_global_norm`` + ``multi_transform`` chain does.

On a batch sharded over a multi-card run's ``data`` axis
(``parallel/mesh.py::shard_batch``) a step makes the whole batch's
numbers: the models run on this rank's rows (BatchNorm with the global
batch's statistics), the losses are computed on the outputs all-gathered
over ``data``, and the gradients, this rank's rows' share of the global
loss's, are summed over ``data`` before the clipping. A state sharded
over ``model`` (``parallel/mesh.py::shard_state``) updates its slices of
the large kernels and all-gathers them whole after the AdamW step.

``precision="bf16"`` (or ``"16"``) is the JAX package's AMP-style mixed
precision: the parameters (not the running statistics), the inputs and the
targets are cast to bf16 where a model is applied, by differentiable casts,
so the gradients reach the float32 parameters as float32; every floating
output is cast back to float32 before the projection, the losses and the
metrics. The master weights, AdamW and the geometry stay float32.
"""
import inspect
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.func import functional_call

from ..losses import (LossContext, LossModes, calculate_losses, primary_loss,
                      resolve_loss_modes)
from ..metrics.base import MetricCollection
from ..models.base import LRSchedule, OptimizerSettings, make_adamw, set_lr
from ..models.trajectory.zero import ZeroTrajectory
from ..parallel.mesh import (DataShard, all_reduce_, data_parallel,
                             data_shard, gather_rows)
from ..utils.device import DeviceLike, resolve_device
from .output_types import MovementsModelOutputType

Params = Dict[str, Dict[str, torch.Tensor]]

DEFAULT_SEED = 22742

#: the flows' ``precision`` values (the JAX CLI's ``--precision``); "16"
#: means bf16, as in the JAX package
PRECISIONS = ("32", "16", "bf16")


def resolve_precision(precision) -> str:
    """``"bf16"`` for ``"16"`` and ``"bf16"``, ``"32"`` for ``"32"``; any
    other value raises ``ValueError``."""
    if str(precision) not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{PRECISIONS}")
    return "32" if str(precision) == "32" else "bf16"


def cast_floats(tree, dtype: torch.dtype):
    """Every floating tensor of ``tree`` (a tensor, or dicts, lists and
    tuples of them; anything else as it is) cast to ``dtype``, by
    differentiable casts."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


def cast_params(tree: Dict[str, torch.Tensor], buffers: set,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A model's parameter dict with its parameters cast to ``dtype`` and
    its persistent buffers (``buffers``: the running statistics) passed
    through as the same tensors, so that a training step's in-place update
    of them lands in the state, in their own dtype (the JAX package keeps
    its mutables in their original dtype)."""
    return {k: v if k in buffers else cast_floats(v, dtype)
            for k, v in tree.items()}


@dataclass
class FlowState:
    """What training carries from step to step: the parameter dict (the
    parameters are leaves that require grad, the models' running
    statistics are not; :func:`state_params`), the AdamW optimizer over
    the parameters, the LR
    schedule of each parameter group that has one, and the number of steps
    taken. ``training_step`` updates it in place. ``sharding`` is the
    state's tensor-parallel slices (``parallel/mesh.py::ModelShards``), or
    None."""
    params: Params
    optimizer: torch.optim.Optimizer
    step: int = 0
    schedules: Dict[str, LRSchedule] = field(default_factory=dict)
    sharding: Any = None


def buffer_names(model: torch.nn.Module) -> set:
    """The names of ``model``'s persistent buffers (in its
    ``state_dict``): the running statistics a parameter dict carries
    beside the parameters."""
    persistent = model.state_dict().keys()
    return {name for name, _ in model.named_buffers() if name in persistent}


def state_params(params: Params, models: Dict[str, torch.nn.Module],
                 device: torch.device) -> Params:
    """Copies of ``params`` on ``device`` for a training state: each
    model's parameters as grad leaves, its persistent buffers
    (:func:`buffer_names`) as tensors without grad, which a training step
    updates in place."""
    out = {}
    for name, tree in params.items():
        buffers = buffer_names(models[name])
        out[name] = {k: v.detach().to(device).clone()
                     .requires_grad_(k not in buffers)
                     for k, v in tree.items()}
    return out


def trained(tree: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """The leaves of a state's parameter dict that training updates through
    AdamW: those that require grad (not the running statistics)."""
    return [v for v in tree.values() if v.requires_grad]


def make_schedules(settings: Dict[str, OptimizerSettings],
                   steps_per_epoch: int) -> Dict[str, LRSchedule]:
    """The LR schedule of each named group whose settings enable one."""
    schedules = {name: s.schedule(steps_per_epoch)
                 for name, s in settings.items()}
    return {name: s for name, s in schedules.items() if s is not None}


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the gradients of ``params``, in
    place and without a host read: each gradient stays as it is where the
    global norm is below ``max_norm``, else becomes ``g / norm * max_norm``
    (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``
    instead). Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def clip_gradients(state: FlowState, gradient_clip_val: float = 0.0) -> None:
    """The first part of the update, after the backward: clip the
    gradients by their global norm over every model, where
    ``gradient_clip_val > 0``. Device work only, so a CUDA graph of the
    step captures it."""
    if gradient_clip_val > 0:
        clip_by_global_norm((p for tree in state.params.values()
                             for p in trained(tree)), gradient_clip_val)


def backward(state: FlowState, loss: torch.Tensor,
             shard: Optional[DataShard], gradient_clip_val: float) -> None:
    """The gradients of ``loss``: set to None first (so that a graph
    captures their memory), the backward, on a sharded batch the sum of
    the ranks' shares over ``data``, the clipping (:func:`clip_gradients`)
    and, for a state sharded over ``model``, each slice's gradient."""
    leaves = [p for tree in state.params.values() for p in trained(tree)]
    for p in leaves:  # the slices' gradients come from these
        p.grad = None
    loss.backward()
    if shard is not None:
        all_reduce_([p.grad for p in leaves if p.grad is not None],
                    shard.mesh.data_group)
    clip_gradients(state, gradient_clip_val)
    if state.sharding is not None:
        state.sharding.slice_gradients()


def optimizer_step(state: FlowState) -> None:
    """The AdamW step, then, for a state sharded over ``model``, the
    slices all-gathered into the whole tensors the forward reads."""
    state.optimizer.step()
    if state.sharding is not None:
        state.sharding.gather_parameters()


def set_lrs(state: FlowState, primary: torch.Tensor) -> Dict[str, float]:
    """Set each scheduled group's lr for this step (ReduceLROnPlateau reads
    ``primary``), on the host; returns the lrs set, by ``lr-<group>``."""
    lrs = {}
    for group in state.optimizer.param_groups:
        schedule = state.schedules.get(group["name"])
        if schedule is not None:
            lr = schedule.lr(state.step, primary)
            set_lr(group, lr)
            lrs[f"lr-{group['name']}"] = lr
    return lrs


def optimizer_update(state: FlowState, primary: torch.Tensor) -> None:
    """The rest of the update: the schedules' lrs (:func:`set_lrs`), the
    AdamW step, the step count. The resident epoch's graphs run the same
    parts: :func:`set_lrs` between two replays, :func:`optimizer_step` as
    the second graph."""
    set_lrs(state, primary)
    optimizer_step(state)
    state.step += 1


class BaseFlow:
    """Common flow machinery. Subclasses define ``_inner_step``."""

    def __init__(self,
                 movements_model: torch.nn.Module,
                 trajectory_model: Optional[torch.nn.Module] = None,
                 loss_modes: Optional[List] = None,
                 loss_weights: Optional[Dict[str, float]] = None,
                 loss_params: Optional[List[float]] = None,
                 mask_missing_joints: bool = True,
                 movements_optimizer: Optional[OptimizerSettings] = None,
                 trajectory_optimizer: Optional[OptimizerSettings] = None,
                 transform: str = "hips_neck",
                 precision: str = "32",
                 gradient_clip_val: float = 0.0,
                 projection_kernel: str = "plain",
                 steps_per_epoch: int = 1,
                 seed: int = DEFAULT_SEED,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        #: "32", or "bf16": the models run in bf16 (module docstring)
        self.precision = resolve_precision(precision)
        #: global-norm gradient clipping over every model's gradients; 0 is
        #: off
        self.gradient_clip_val = float(gradient_clip_val or 0.0)
        self.movements_model = movements_model.to(self.device)
        self.trajectory_model = (trajectory_model if trajectory_model
                                 is not None else ZeroTrajectory()
                                 ).to(self.device)
        self.mask_missing_joints = mask_missing_joints
        self.loss_weights = loss_weights or {}
        self.loss_params = loss_params

        if not loss_modes:
            loss_modes = [LossModes.loc_2d]
        self.requested_loss_modes = [
            LossModes[m] if isinstance(m, str) else m for m in loss_modes]
        self.losses_to_calculate = resolve_loss_modes(self.requested_loss_modes)
        self.movements_optimizer = movements_optimizer or OptimizerSettings()
        self.trajectory_optimizer = trajectory_optimizer or OptimizerSettings()
        #: optimizer steps in an epoch: the LR schedules count their epochs
        #: in it. The trainer sets it from the data module before
        #: ``init_state``; 1 makes an epoch one step
        self.steps_per_epoch = max(1, int(steps_per_epoch))
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
        #: each model's persistent buffers, which a bf16 step leaves float32
        self._buffers = {id(m): buffer_names(m)
                         for m in (self.movements_model,
                                   self.trajectory_model)}
        self.metrics = MetricCollection(self.get_metrics())
        self.initial_metrics = MetricCollection(
            {**self.get_metrics(), **self.get_initial_metrics()})

    @property
    def needs_confidence(self) -> bool:
        """Whether the data module's inputs carry a confidence channel."""
        return getattr(self.movements_model, "needs_confidence", False)

    @property
    def needs_heatmaps(self) -> bool:
        """Whether the data module's targets carry heatmaps."""
        return getattr(self.movements_model, "needs_heatmaps", False)

    # -- metrics -----------------------------------------------------------
    def get_metrics(self) -> Dict[str, Any]:
        """The metrics accumulated over every evaluation pass."""
        return {}

    def get_initial_metrics(self) -> Dict[str, Any]:
        """Metrics only the fit-start baseline pass reports."""
        return {}

    def initial_preds(self, inputs, targets) -> Dict[str, Any]:
        """The fit-start baseline's predictions: the inputs themselves."""
        key = "projection_2d_deformed" \
            if targets.get("projection_2d_deformed") is not None \
            else "projection_2d"
        return {"projection_2d": targets.get(key),
                "projection_2d_transformed": inputs[..., :2]}

    def on_epoch_start(self, epoch: int) -> bool:
        """Per-epoch hook, which the trainer calls before each epoch: the
        teacher-forcing ratio falls by ``teacher_force_drop`` an epoch
        (from the second epoch on, for a model that forces). Returns
        whether the model changed."""
        model = self.movements_model
        drop = getattr(model, "teacher_force_drop", 0.0)
        ratio = getattr(model, "teacher_force_ratio", 0.0)
        if drop and ratio and epoch > 0 \
                and getattr(model, "teacher_mode", "no_force") != "no_force":
            model.teacher_force_ratio = max(0.0, ratio - drop)
            return True
        return False

    # -- parameters --------------------------------------------------------
    def init_params(self) -> Params:
        """The models' current (seeded-init) parameters and running
        statistics (their ``state_dict``s), on the flow's device, as the
        parameter dict the steps take."""
        return {"movements": {k: v.detach() for k, v in
                              self.movements_model.state_dict().items()},
                "trajectory": {k: v.detach() for k, v in
                               self.trajectory_model.state_dict().items()}}

    # -- state -------------------------------------------------------------
    def init_state(self, params: Optional[Params] = None) -> FlowState:
        """A training state over copies of ``params`` (default: the models'
        own seeded init): one AdamW over both models' parameters, a
        parameter group per model with its own settings, as the JAX
        package's per-model ``optax.multi_transform``; the running
        statistics ride along without grad (:func:`state_params`)."""
        params = self.init_params() if params is None else params
        params = state_params(params, {"movements": self.movements_model,
                                       "trajectory": self.trajectory_model},
                              self.device)
        optimizer = make_adamw({
            "movements": (self.movements_optimizer,
                          trained(params["movements"])),
            "trajectory": (self.trajectory_optimizer,
                           trained(params["trajectory"]))})
        return FlowState(params=params, optimizer=optimizer, step=0,
                         schedules=make_schedules(
                             self.optimizer_settings_map(),
                             self.steps_per_epoch))

    def optimizer_settings_map(self) -> Dict[str, OptimizerSettings]:
        """Per-model optimizer settings, keyed like ``state.params``."""
        return {"movements": self.movements_optimizer,
                "trajectory": self.trajectory_optimizer}

    @staticmethod
    def current_lrs(state: FlowState) -> Dict[str, float]:
        """Per-model learning rates, for step logging: the lr the last
        update took (before the first, the first's). The JAX package's
        ``current_lrs`` gives the same for ReduceLROnPlateau and the next
        update's for the step-based schedules. A capturable group's lr is
        read from the device."""
        return {f"lr-{group['name']}": float(group["lr"])
                for group in state.optimizer.param_groups}

    @staticmethod
    def param_counts(state: FlowState) -> Dict[str, int]:
        """Per-model parameter counts (the running statistics left out, as
        the JAX package counts ``state.params`` alone)."""
        return {name: sum(v.numel() for v in trained(tree))
                for name, tree in state.params.items()}

    # -- model application -------------------------------------------------
    def _apply_model(self, model, params, inputs, targets, training: bool):
        kwargs = {"training": training}
        if training and any(model is m for m in self._takes_generator):
            kwargs["generator"] = self.generator
        if self.precision == "bf16":
            params = cast_params(params, self._buffers[id(model)],
                                 torch.bfloat16)
            inputs = cast_floats(inputs, torch.bfloat16)
            targets = cast_floats(targets, torch.bfloat16)
        out = functional_call(model, params, (inputs, targets), kwargs)
        if self.precision == "bf16":
            out = cast_floats(out, torch.float32)
        return out

    def _inner_step(self, params: Params, batch, training: bool):
        """-> sliced dict. Flow-specific."""
        raise NotImplementedError

    # -- losses ------------------------------------------------------------
    def _compute_losses(self, sliced, targets) -> Dict[str, torch.Tensor]:
        ctx = LossContext(
            input_nodes=self.movements_model.input_nodes,
            output_nodes=self.movements_model.output_nodes,
            sliced=sliced, targets=targets,
            loss_weights=self.loss_weights, loss_params=self.loss_params,
            mask_missing_joints=self.mask_missing_joints,
        )
        return calculate_losses(
            self.losses_to_calculate, self.requested_loss_modes, ctx)

    # -- steps -------------------------------------------------------------
    def training_step(self, state: FlowState, batch
                      ) -> Tuple[FlowState, Dict[str, torch.Tensor]]:
        """One AdamW step on ``batch``, in place: :meth:`backward_step`
        (forward, losses, the primary loss's backward, clipping), then
        :func:`optimizer_update` (the schedules' lrs, AdamW, ``step +=
        1``). Returns the state and the logs ``train_loss/<mode>`` and
        ``train_loss/primary``, as tensors on the device (reading them
        synchronises with the card). The gradients stay in the parameters'
        ``.grad`` until the next step."""
        logs = self.backward_step(state, batch)
        optimizer_update(state, logs["train_loss/primary"])
        return state, logs

    def backward_step(self, state: FlowState, batch
                      ) -> Dict[str, torch.Tensor]:
        """The device half of a training step: forward, losses, the
        gradients (:func:`backward`: on a sharded batch those of the whole
        batch's losses), clipping; returns the step's logs."""
        shard = data_shard(batch)
        with data_parallel(shard):
            sliced = self._inner_step(state.params, batch, training=True)
        sliced = gather_rows(sliced, shard)
        loss_dict = self._compute_losses(sliced, sliced["targets"])
        _, primary = primary_loss(loss_dict, self.requested_loss_modes)
        backward(state, primary, shard, self.gradient_clip_val)
        logs = {f"train_loss/{k}": v.detach() for k, v in loss_dict.items()}
        logs["train_loss/primary"] = primary.detach()
        return logs

    @torch.no_grad()
    def eval_step(self, params: Params, batch):
        """-> (loss dict, preds, targets) for metric accumulation. On a
        sharded batch the losses are the whole batch's and the preds and
        targets this rank's rows'."""
        shard = data_shard(batch)
        with data_parallel(shard):
            sliced = self._inner_step(params, batch, training=False)
        whole = gather_rows(sliced, shard)
        loss_dict = self._compute_losses(whole, whole["targets"])
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
