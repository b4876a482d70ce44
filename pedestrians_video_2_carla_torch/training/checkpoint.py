"""Checkpointing: best-so-far saving and resume, with the JAX package's
layout (``ModelCheckpoint(monitor='val_loss/primary', mode=min,
save_top_k=1)`` in the reference): ``best-step<N>.pt`` for the lowest
``val_loss/primary``, ``best.json`` naming it with that value, and
``last.pt``.

An archive is the port's own format: ``torch.save`` of ``{"params",
"optimizer", "schedules", "step"}`` (the parameter dict with the models'
running statistics, the optimizer's ``state_dict()``, the LR schedules'
states and the step count), loaded with ``weights_only=True``.
An optimizer restores into the form it has (``models/base.py::
set_capturable``): a capturable AdamW's step counts and lrs, device
tensors, come back on the device, a host-stepped one's as before.
Saves are synchronous: the host copy and the file write finish before
``save`` returns. Every file is written to a temporary name and
``os.replace``d into place, so a crash never leaves a torn checkpoint.
"""
import json
import os
from typing import Dict, Optional

import torch

from ..flows.base import FlowState
from ..models.base import is_capturable, set_capturable

SUFFIX = ".pt"
#: the metric whose lowest value makes the best checkpoint
MONITOR = "val_loss/primary"


def _snapshot(state: FlowState) -> Dict:
    """A host copy of everything a resumed run needs."""
    return {"params": {name: {k: v.detach().cpu().clone()
                              for k, v in tree.items()}
                       for name, tree in state.params.items()},
            "optimizer": _to_cpu(state.optimizer.state_dict()),
            "schedules": {name: _to_cpu(s.state_dict())
                          for name, s in state.schedules.items()},
            "step": int(state.step)}


def is_archive(path: str) -> bool:
    """Whether ``path`` is one of the port's own archives (``params`` and
    ``step`` at its top), as against a reference torch checkpoint."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    return isinstance(data, dict) and {"params", "step"} <= set(data)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _write(path: str, obj) -> None:
    """Atomic write: temp file + rename."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, dirpath: str):
        self.dirpath = dirpath
        self.best_value: Optional[float] = None
        self.best_path: Optional[str] = None
        os.makedirs(dirpath, exist_ok=True)

    def wait(self) -> None:
        """Saves are synchronous: nothing is ever pending."""

    def save(self, state: FlowState, metrics: Dict[str, float],
             step: int) -> bool:
        """End-of-validation save: ``last``, and ``best`` when
        ``val_loss/primary`` fell (``save_top_k=1``: the previous best is
        removed). Returns whether a new best was saved."""
        snapshot = _snapshot(state)
        value = metrics.get(MONITOR)
        improved = value is not None and (self.best_value is None
                                          or value < self.best_value)
        if improved:
            prev = self.best_path
            self.best_value = float(value)
            self.best_path = os.path.join(self.dirpath, f"best-step{step}")
            # the new best first: a failed write leaves the previous best
            # (and its best.json) intact
            _write(self.best_path + SUFFIX, snapshot)
            meta_tmp = os.path.join(self.dirpath, "best.json.tmp")
            with open(meta_tmp, "w") as f:
                json.dump({"path": self.best_path, "step": step,
                           MONITOR: self.best_value}, f)
            os.replace(meta_tmp, os.path.join(self.dirpath, "best.json"))
            if prev and prev != self.best_path \
                    and os.path.exists(prev + SUFFIX):
                os.remove(prev + SUFFIX)
        _write(os.path.join(self.dirpath, "last") + SUFFIX, snapshot)
        return improved

    def restore(self, state: FlowState, path: Optional[str] = None,
                weights_only: bool = False) -> FlowState:
        """Load a checkpoint (default: the best) into ``state``,
        in place: the parameters and running statistics, and unless
        ``weights_only`` the optimizer
        state, the LR schedules' states and the step count. ``path`` may name the archive with or
        without its ``.pt``."""
        if path is None:
            with open(os.path.join(self.dirpath, "best.json")) as f:
                path = json.load(f)["path"]
        if not path.endswith(SUFFIX):
            path = path + SUFFIX
        data = torch.load(path, map_location="cpu", weights_only=True)
        if set(data["params"]) != set(state.params):
            raise ValueError(f"{path}: models {sorted(data['params'])}, "
                             f"expected {sorted(state.params)}")
        with torch.no_grad():
            for name, tree in state.params.items():
                loaded = data["params"][name]
                if set(loaded) != set(tree):
                    raise ValueError(
                        f"{path}: {name} holds {sorted(loaded)}, expected "
                        f"{sorted(tree)}")
                for k, v in tree.items():
                    v.copy_(loaded[k])
        if not weights_only:
            capturable = is_capturable(state.optimizer)
            state.optimizer.load_state_dict(data["optimizer"])
            set_capturable(state.optimizer, capturable)
            schedules = data.get("schedules", {})
            if set(schedules) != set(state.schedules):
                raise ValueError(f"{path}: LR schedules {sorted(schedules)}, "
                                 f"expected {sorted(state.schedules)}")
            for name, schedule in state.schedules.items():
                schedule.load_state_dict(schedules[name])
            state.step = int(data["step"])
        return state


def resolve_ckpt_path(path: str, search_root: str = "outputs") -> str:
    """A ``--ckpt_path`` with a scheme -> a local path. ``file://x`` is
    ``x``. ``wandb://entity/project/run[:version]`` names a W&B artifact,
    which would need the network; it is looked up locally instead: the
    run's directory under ``search_root`` (or ``$WANDB_ARTIFACTS_DIR``),
    and in its ``checkpoints/`` the newest ``best*`` archive, else the
    newest archive, without its suffix. Any other path is returned as it
    is."""
    if path.startswith("file://"):
        return path[len("file://"):]
    if not path.startswith("wandb://"):
        return path
    import glob

    run = path[len("wandb://"):].rstrip("/").split("/")[-1].split(":")[0]
    root = os.environ.get("WANDB_ARTIFACTS_DIR", search_root)
    hits = sorted(glob.glob(os.path.join(root, "**", run, "checkpoints",
                                         "*" + SUFFIX), recursive=True),
                  key=os.path.getmtime)
    best = [h for h in hits if os.path.basename(h).startswith("best")]
    if best or hits:
        return (best or hits)[-1][:-len(SUFFIX)]
    raise FileNotFoundError(
        f"no local checkpoint for {path!r} under {root!r} (looked for "
        f"**/{run}/checkpoints/*{SUFFIX})")
