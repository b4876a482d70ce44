"""Model-layer foundations: the optimizer configuration, the LR schedules
and the movements-model output helpers."""
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..flows.output_types import MovementsModelOutputType
from ..ops.rotations import rotation_6d_to_matrix

#: Adam's moment decays and epsilon, as ``optax.adamw``'s defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass(frozen=True)
class OptimizerSettings:
    """AdamW with decoupled weight decay, as the JAX package's
    ``optax.adamw``, and an optional LR schedule (:class:`LRSchedule`:
    ReduceLROnPlateau, StepLR or CosineAnnealingWarmRestarts). ``lr=None``
    selects the defaults: 5e-2 with a scheduler enabled, 1e-4 without."""
    lr: Optional[float] = None
    enable_lr_scheduler: bool = False
    scheduler_type: str = "ReduceLROnPlateau"
    scheduler_gamma: float = 0.98
    scheduler_step_size: int = 1
    scheduler_min_lr: float = 1e-8
    scheduler_patience: int = 50
    scheduler_cooldown: int = 20
    weight_decay: float = 1e-8

    @property
    def learning_rate(self) -> float:
        if self.lr is not None:
            return self.lr
        return 5e-2 if self.enable_lr_scheduler else 1e-4

    @classmethod
    def from_kwargs(cls, prefix: str, kwargs: Dict[str, Any]
                    ) -> "OptimizerSettings":
        """Pick up ``{prefix}_lr`` etc. from flat CLI kwargs."""
        def g(name, default):
            v = kwargs.get(f"{prefix}_{name}")
            return default if v is None else v
        return cls(
            lr=kwargs.get(f"{prefix}_lr"),
            enable_lr_scheduler=bool(g("enable_lr_scheduler", False)),
            scheduler_type=g("scheduler_type", "ReduceLROnPlateau"),
            scheduler_gamma=g("scheduler_gamma", 0.98),
            scheduler_step_size=g("scheduler_step_size", 1),
            scheduler_min_lr=g("scheduler_min_lr", 1e-8),
            scheduler_patience=g("scheduler_patience", 50),
            scheduler_cooldown=g("scheduler_cooldown", 20),
            weight_decay=g("weight_decay", 1e-8),
        )

    def param_group(self, params: Iterable[torch.Tensor], name: str
                    ) -> Dict[str, Any]:
        """An AdamW parameter group with these settings, named ``name``, at
        the unscheduled lr (a schedule sets the group's lr every step)."""
        return {"params": list(params), "lr": self.learning_rate,
                "weight_decay": self.weight_decay, "name": name}

    def make(self, params: Iterable[torch.Tensor]) -> torch.optim.AdamW:
        """AdamW over ``params`` with these settings (a schedule, if
        enabled, is :meth:`schedule`'s, driven by the caller)."""
        return make_adamw({"params": (self, params)})

    def schedule(self, steps_per_epoch: int = 1) -> Optional["LRSchedule"]:
        """The LR schedule of these settings, or None when none is
        enabled."""
        if not self.enable_lr_scheduler:
            return None
        return LRSchedule(self, steps_per_epoch)

    def hparams(self, prefix: str) -> Dict[str, Any]:
        return {
            f"{prefix}_enable_lr_scheduler": self.enable_lr_scheduler,
            f"{prefix}_lr": self.learning_rate,
            f"{prefix}_scheduler_type": self.scheduler_type,
            f"{prefix}_scheduler_gamma": self.scheduler_gamma,
            f"{prefix}_scheduler_step_size": self.scheduler_step_size,
            f"{prefix}_scheduler_min_lr": self.scheduler_min_lr,
            f"{prefix}_scheduler_patience": self.scheduler_patience,
            f"{prefix}_scheduler_cooldown": self.scheduler_cooldown,
            f"{prefix}_weight_decay": self.weight_decay,
        }


def make_adamw(groups: Dict[str, Tuple[OptimizerSettings,
                                       Iterable[torch.Tensor]]]
               ) -> torch.optim.AdamW:
    """One AdamW with a parameter group per name, each with its own
    settings (the JAX package's per-model ``optax.multi_transform``):
    betas (0.9, 0.999), eps 1e-8, decay ``lr * weight_decay * param`` per
    step, decoupled from the gradient. It steps on the host
    (``capturable=False``) until :func:`set_capturable` says otherwise."""
    return torch.optim.AdamW(
        [settings.param_group(params, name)
         for name, (settings, params) in groups.items()],
        betas=ADAM_BETAS, eps=ADAM_EPS)


def set_capturable(optimizer: torch.optim.Optimizer,
                   capturable: bool) -> None:
    """Switch an AdamW in place between its host-stepped form and the form
    a CUDA graph can capture (``capturable=True``): there each group's lr is
    a float32 tensor on its parameters' device, which :func:`set_lr` writes
    between graph replays, and each parameter's step count a device tensor,
    so the bias corrections are computed on the device (in float32, where
    the host form computes them in float64: the trajectories differ by
    rounding). The moments are kept."""
    for group in optimizer.param_groups:
        device = group["params"][0].device
        group["capturable"] = capturable
        lr = group["lr"]
        if capturable:
            group["lr"] = lr.to(device) if isinstance(lr, torch.Tensor) \
                else torch.tensor(float(lr), dtype=torch.float32,
                                  device=device)
        else:
            group["lr"] = float(lr)
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(
                    device=device if capturable else "cpu",
                    dtype=torch.float32)


def is_capturable(optimizer: torch.optim.Optimizer) -> bool:
    return all(g.get("capturable", False) for g in optimizer.param_groups)


def set_lr(group: Dict[str, Any], value: float) -> None:
    """Set a parameter group's lr: in place on the device for a capturable
    group (a graph reads the same tensor), else as a float."""
    if isinstance(group["lr"], torch.Tensor):
        group["lr"].fill_(value)
    else:
        group["lr"] = value


SCHEDULER_TYPES = ("ReduceLROnPlateau", "StepLR",
                   "CosineAnnealingWarmRestarts")
#: the plateau rule's relative improvement threshold (optax's rtol)
PLATEAU_RTOL = 1e-4
#: CosineAnnealingWarmRestarts' number of periods; past them the lr stays
#: at ``scheduler_min_lr``
COSINE_PERIODS = 64


class LRSchedule:
    """The lr each AdamW update of a parameter group takes, by the rules of
    the JAX package's optax chains (``models/base.py::OptimizerSettings.
    make``), with every epoch-granular quantity counted in
    ``steps_per_epoch`` optimizer steps. The owner calls :meth:`lr` once a
    step, before the update, with the step's index (0 for the first update)
    and its primary loss, and sets the group's lr to it: AdamW's decay
    ``p *= 1 - lr * wd`` then scales with the update, as the optax chains
    scale the whole update.

    - ``StepLR``: ``lr * gamma ** floor(step / (step_size * steps_per_epoch))``
      (optax ``exponential_decay(staircase=True)``).
    - ``CosineAnnealingWarmRestarts``: ``min_lr + (lr - min_lr) (1 + cos(pi
      t / T)) / 2`` with ``t = step mod T``, ``T = step_size *
      steps_per_epoch``, over 64 periods, then ``min_lr`` (optax
      ``sgdr_schedule`` over 64 cosine decays).
    - ``ReduceLROnPlateau``: optax ``contrib.reduce_on_plateau`` with
      ``accumulation_size = steps_per_epoch``: the step losses are averaged
      over an epoch (in float32, on the losses' device); the step that
      closes the epoch compares the average with the best so far (an
      improvement is ``avg < (1 - 1e-4) best``), counts a plateau epoch
      otherwise, multiplies the scale by ``gamma`` when the count reaches
      ``patience`` (then counts ``cooldown`` epochs in which the plateau
      count stays at 0), floors the scale at ``min_lr / lr``, and applies
      the new scale to its own update. The host reads the average once an
      epoch, at that step.
    """

    def __init__(self, settings: OptimizerSettings, steps_per_epoch: int = 1):
        if settings.scheduler_type not in SCHEDULER_TYPES:
            raise ValueError(
                f"Unknown lr scheduler type: {settings.scheduler_type}")
        if settings.scheduler_type == "ReduceLROnPlateau" \
                and not 0.0 < settings.scheduler_gamma < 1.0:
            raise ValueError(f"Factor must be in the range (0, 1), got "
                             f"factor = {settings.scheduler_gamma}.")
        self.settings = settings
        self.steps_per_epoch = max(1, int(steps_per_epoch))
        # the plateau rule's state, float32 as optax's
        self.scale = np.float32(1.0)
        self.best_value = np.float32(np.inf)
        self.plateau_count = 0
        self.cooldown_count = 0
        self.count = 0
        self.avg_value: Optional[torch.Tensor] = None

    def lr(self, step: int, value: Optional[torch.Tensor] = None) -> float:
        """The lr of the update with index ``step``; ``value`` (the step's
        primary loss) feeds ReduceLROnPlateau."""
        s = self.settings
        base = s.learning_rate
        if s.scheduler_type == "StepLR":
            transition = s.scheduler_step_size * self.steps_per_epoch
            if transition <= 0:
                return base
            return base * s.scheduler_gamma ** math.floor(step / transition)
        if s.scheduler_type == "CosineAnnealingWarmRestarts":
            period = max(1, s.scheduler_step_size) * self.steps_per_epoch
            if step >= (COSINE_PERIODS - 1) * period:
                t = min(step - (COSINE_PERIODS - 1) * period, period)
            else:
                t = step % period
            alpha = s.scheduler_min_lr / base if base else 0.0
            decay = 0.5 * (1.0 + math.cos(math.pi * t / period))
            return base * ((1.0 - alpha) * decay + alpha)
        if value is None:
            raise ValueError("ReduceLROnPlateau needs the step's loss")
        self._observe(value)
        return base * float(self.scale)

    def _observe(self, value: torch.Tensor) -> None:
        value = value.detach().to(torch.float32)
        new_count = self.count + 1
        avg = torch.zeros_like(value) if self.avg_value is None \
            else self.avg_value.to(value.device)
        self.avg_value = (self.count * avg + value) / new_count
        self.count = new_count
        if new_count == self.steps_per_epoch:
            self._close_epoch(np.float32(self.avg_value.item()))

    def _close_epoch(self, avg: np.float32) -> None:
        s = self.settings
        improved = avg < np.float32(1.0 - PLATEAU_RTOL) * self.best_value
        if improved:
            self.best_value = avg
        plateau = 0 if improved else self.plateau_count + 1
        if self.cooldown_count > 0:
            self.plateau_count = 0
            self.cooldown_count -= 1
        else:
            hit = plateau == s.scheduler_patience
            self.plateau_count = 0 if hit else plateau
            min_scale = np.float32(s.scheduler_min_lr / s.learning_rate)
            self.scale = max(np.float32(self.scale * np.float32(
                s.scheduler_gamma)) if hit else self.scale, min_scale)
            self.cooldown_count = s.scheduler_cooldown if hit else 0
        self.count = 0
        self.avg_value = None

    def state_dict(self) -> Dict[str, Any]:
        """The plateau rule's state, for checkpoints (the step-based
        schedules are functions of the step count alone)."""
        return {"scale": float(self.scale),
                "best_value": float(self.best_value),
                "plateau_count": self.plateau_count,
                "cooldown_count": self.cooldown_count, "count": self.count,
                "avg_value": None if self.avg_value is None
                else self.avg_value.detach().cpu().clone()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.scale = np.float32(state["scale"])
        self.best_value = np.float32(state["best_value"])
        self.plateau_count = int(state["plateau_count"])
        self.cooldown_count = int(state["cooldown_count"])
        self.count = int(state["count"])
        self.avg_value = state["avg_value"]


def movements_output_features(output_type: MovementsModelOutputType) -> int:
    """Raw per-joint feature count of each output type."""
    return {
        MovementsModelOutputType.pose_changes: 6,
        MovementsModelOutputType.relative_rot: 6,
        MovementsModelOutputType.absolute_loc: 3,
        MovementsModelOutputType.absolute_loc_rot: 9,
        MovementsModelOutputType.pose_2d: 2,
    }[output_type]


def format_movements_output(outputs: torch.Tensor,
                            output_type: MovementsModelOutputType):
    """Raw (B, L, P, x) model output -> projection-module input (6D ->
    rotation matrices)."""
    if output_type in (MovementsModelOutputType.pose_changes,
                       MovementsModelOutputType.relative_rot):
        return rotation_6d_to_matrix(outputs)
    if output_type == MovementsModelOutputType.absolute_loc_rot:
        return outputs[..., :3], rotation_6d_to_matrix(outputs[..., 3:])
    return outputs
