"""Model-layer foundations: the optimizer configuration and the
movements-model output helpers."""
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from ..flows.output_types import MovementsModelOutputType
from ..ops.rotations import rotation_6d_to_matrix

#: Adam's moment decays and epsilon, as ``optax.adamw``'s defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass(frozen=True)
class OptimizerSettings:
    """AdamW with decoupled weight decay, as the JAX package's
    ``optax.adamw``. ``lr=None`` selects the defaults: 5e-2 with a scheduler
    enabled, 1e-4 without. The LR schedulers are not ported yet: building
    an optimizer with ``enable_lr_scheduler`` raises."""
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
        """An AdamW parameter group with these settings, named ``name``."""
        if self.enable_lr_scheduler:
            raise NotImplementedError(
                "LR schedulers are not ported yet (see ROADMAP.md)")
        return {"params": list(params), "lr": self.learning_rate,
                "weight_decay": self.weight_decay, "name": name}

    def make(self, params: Iterable[torch.Tensor]) -> torch.optim.AdamW:
        """AdamW over ``params`` with these settings."""
        return make_adamw({"params": (self, params)})

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
    step, decoupled from the gradient."""
    return torch.optim.AdamW(
        [settings.param_group(params, name)
         for name, (settings, params) in groups.items()],
        betas=ADAM_BETAS, eps=ADAM_EPS)


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
