"""Crossing/action classification flow (reference
``modules/flow/classification.py:41-596``): classifier -> logits ->
cross-entropy (or binary cross-entropy) loss, the confusion-matrix metric
stack, one label per clip.

As the other flows, it applies its model functionally to an explicit
parameter dict, here ``{"classification": state_dict}``, and trains it with
one AdamW group (clipped by ``gradient_clip_val``, on its LR schedule if
enabled). Its baseline, which the trainer logs at the start of a fit, is
the prevalent class of each batch (``initial_preds``) under the same
metrics (``initial_metrics``). ``precision="bf16"`` runs the classifier in
bf16 as the other flows run their models (``flows/base.py``); the logits
go back to float32 before the loss.
"""
from typing import Any, Dict, Optional, Tuple

import torch
from torch.func import functional_call
from torch.nn import functional as F

from ..metrics.base import MetricCollection
from ..metrics.classification import (AUROC, Accuracy, ConfusionMatrixMetric,
                                      F1Score, PRCurve, Precision, ROCCurve,
                                      Recall)
from ..models.base import OptimizerSettings, make_adamw
from ..models.classification import CLASSIFICATION_MODELS
from ..utils.device import DeviceLike, resolve_device
from ..parallel.mesh import data_parallel, data_shard, gather_rows
from .base import (DEFAULT_SEED, BaseFlow, FlowState, Params, backward,
                   buffer_names, cast_floats, cast_params, make_schedules,
                   optimizer_update, resolve_precision, state_params,
                   trained)
from .output_types import ClassificationModelOutputType


class ClassificationFlow:
    def __init__(self,
                 classification_model: Optional[torch.nn.Module] = None,
                 classification_targets_key: str = "crossing",
                 classification_average: str = "macro",
                 num_classes: int = 2,
                 classification_optimizer: Optional[OptimizerSettings] = None,
                 gradient_clip_val: float = 0.0,
                 precision: str = "32",
                 steps_per_epoch: int = 1,
                 seed: int = DEFAULT_SEED,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        #: "32", or "bf16": the classifier runs in bf16
        self.precision = resolve_precision(precision)
        #: global-norm gradient clipping; 0 is off
        self.gradient_clip_val = float(gradient_clip_val or 0.0)
        #: optimizer steps in an epoch, for the LR schedule (set by the
        #: trainer before ``init_state``)
        self.steps_per_epoch = max(1, int(steps_per_epoch))
        if classification_model is None:
            classification_model = self.get_default_models()[
                "classification"](generator=torch.Generator().manual_seed(seed))
        self.classification_model = classification_model.to(self.device)
        self._buffers = buffer_names(self.classification_model)
        self.targets_key = classification_targets_key
        self.outputs_key = classification_targets_key + "_logits"
        self.num_classes = num_classes
        self.classification_optimizer = classification_optimizer \
            or OptimizerSettings()
        #: draws the dropout masks of the training steps, on the flow's device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        if classification_average == "benchmark":
            # the PedestrianActionBenchmark protocol (reference
            # ``classification.py:59-75``)
            self.average = {"Accuracy": "micro", "Precision": "none",
                            "Recall": "none", "F1Score": "none"}
        else:
            self.average = {k: classification_average for k in
                            ("Accuracy", "Precision", "Recall", "F1Score")}
        self.binary = (num_classes == 2 and self.classification_model.
                       output_type == ClassificationModelOutputType.binary)
        #: the flow has one loss and no loss modes
        self.requested_loss_modes = []
        self.metrics = MetricCollection(self.get_metrics())
        self.initial_metrics = MetricCollection(self.get_metrics())

    @classmethod
    def get_default_models(cls):
        return {"classification": CLASSIFICATION_MODELS["LSTM"]}

    @property
    def needs_confidence(self) -> bool:
        return getattr(self.classification_model, "needs_confidence", False)

    def get_metrics(self) -> Dict[str, Any]:
        kw = dict(preds_key=self.outputs_key, targets_key=self.targets_key,
                  num_classes=self.num_classes, binary=self.binary)
        hist_kw = dict(preds_key=self.outputs_key,
                       targets_key=self.targets_key, binary=self.binary)
        metrics = {
            "Accuracy": Accuracy(average=self.average["Accuracy"], **kw),
            "Precision": Precision(average=self.average["Precision"], **kw),
            "Recall": Recall(average=self.average["Recall"], **kw),
            "F1Score": F1Score(average=self.average["F1Score"], **kw),
            "ConfusionMatrix": ConfusionMatrixMetric(**kw),
        }
        if self.num_classes <= 2:
            # the score-histogram metrics are binary curves (positive-class
            # probability); with more classes they would quietly become a
            # class-1-vs-rest curve, so they are left out instead
            metrics.update({"AUROC": AUROC(**hist_kw),
                            "ROC": ROCCurve(**hist_kw),
                            "PRCurve": PRCurve(**hist_kw)})
        return metrics

    def initial_preds(self, inputs, targets) -> Dict[str, torch.Tensor]:
        """The prevalent-class baseline: every clip of the batch gets the
        batch's most frequent label (the lowest on a tie), as logits of
        +-5 (one logit a clip for a binary model) or a one-hot of 5 / -5."""
        labels = targets.get(self.targets_key)
        if labels is None:
            return {}
        flat = labels.reshape(-1).long()
        counts = torch.bincount(flat, minlength=self.num_classes)
        prevalent = torch.argmax(counts[:self.num_classes])
        ones = torch.ones(flat.shape[0], device=flat.device)
        if self.binary:
            logits = torch.where(prevalent == 1, 5.0, -5.0) * ones
        else:
            logits = F.one_hot(prevalent * ones.long(), self.num_classes) \
                .float() * 10.0 - 5.0
        return {self.outputs_key: logits}

    # -- parameters and state -------------------------------------------------
    def init_params(self) -> Params:
        """The model's current (seeded-init) parameters, on the flow's
        device, as the parameter dict the steps take."""
        return {"classification": {
            k: v.detach() for k, v in
            self.classification_model.state_dict().items()}}

    def init_state(self, params: Optional[Params] = None) -> FlowState:
        """A training state over copies of ``params`` (default: the model's
        own seeded init): AdamW with the one group "classification" over
        the model's parameters; persistent buffers ride along without grad
        (:func:`~.base.state_params`)."""
        params = self.init_params() if params is None else params
        params = state_params(
            params, {"classification": self.classification_model},
            self.device)
        optimizer = make_adamw({"classification": (
            self.classification_optimizer,
            trained(params["classification"]))})
        return FlowState(params=params, optimizer=optimizer, step=0,
                         schedules=make_schedules(
                             self.optimizer_settings_map(),
                             self.steps_per_epoch))

    def optimizer_settings_map(self) -> Dict[str, OptimizerSettings]:
        return {"classification": self.classification_optimizer}

    def on_epoch_start(self, epoch: int) -> bool:
        return False

    current_lrs = staticmethod(BaseFlow.current_lrs)
    param_counts = staticmethod(BaseFlow.param_counts)

    # -- steps ----------------------------------------------------------------
    def _apply(self, params: Params, inputs, training: bool) -> torch.Tensor:
        params = params["classification"]
        if self.precision == "bf16":
            params = cast_params(params, self._buffers, torch.bfloat16)
            inputs = cast_floats(inputs, torch.bfloat16)
        logits = functional_call(
            self.classification_model, params, (inputs,),
            {"training": training,
             "generator": self.generator if training else None})
        return cast_floats(logits, torch.float32) \
            if self.precision == "bf16" else logits

    def _loss(self, logits: torch.Tensor, targets) -> torch.Tensor:
        labels = targets[self.targets_key].reshape(-1)
        if self.binary:
            return F.binary_cross_entropy_with_logits(
                logits.reshape(-1), labels.to(logits.dtype))
        return F.cross_entropy(logits, labels.long())

    def training_step(self, state: FlowState, batch
                      ) -> Tuple[FlowState, Dict[str, torch.Tensor]]:
        """One AdamW step on ``batch``, in place (:meth:`backward_step`, then
        :func:`~.base.optimizer_update`); returns the state and
        ``{"train_loss/primary": loss}`` (a tensor on the device)."""
        logs = self.backward_step(state, batch)
        optimizer_update(state, logs["train_loss/primary"])
        return state, logs

    def backward_step(self, state: FlowState, batch
                      ) -> Dict[str, torch.Tensor]:
        """The device half of :meth:`training_step`: forward, loss,
        gradients, clipping (``BaseFlow.backward_step``; on a sharded
        batch the loss is the whole batch's)."""
        inputs, targets, _ = batch
        shard = data_shard(batch)
        with data_parallel(shard):
            logits = self._apply(state.params, inputs, True)
        logits, targets = gather_rows((logits, targets), shard)
        loss = self._loss(logits, targets)
        backward(state, loss, shard, self.gradient_clip_val)
        return {"train_loss/primary": loss.detach()}

    @torch.no_grad()
    def eval_step(self, params: Params, batch):
        """-> (loss dict, preds, targets) for metric accumulation (on a
        sharded batch the loss of the whole batch, the logits and targets
        of this rank's rows)."""
        inputs, targets, _ = batch
        logits = self._apply(params, inputs, False)
        loss = self._loss(*gather_rows((logits, targets), data_shard(batch)))
        return ({"classification": loss, "primary": loss},
                {self.outputs_key: logits}, targets)
