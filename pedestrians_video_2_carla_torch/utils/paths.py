"""Run ids from log and checkpoint paths, and ``resolve_ckpt_path`` (from
``training/checkpoint.py``, where the CLI takes it)."""
import os
import re

from ..training.checkpoint import resolve_ckpt_path  # noqa: F401

_RUN_RE = re.compile(r"^.*?(([a-z]+-?)?[a-z0-9]+)(\:v[0-9]+)?$")


def get_run_id_from_log_dir(log_dir: str) -> str:
    """The run id in a log directory's last path component."""
    m = _RUN_RE.match(log_dir.rstrip(os.path.sep).split(os.path.sep)[-1])
    if m is None:
        raise ValueError(f"cannot extract run id from {log_dir!r}")
    return m.group(1)


def get_run_id_from_checkpoint_path(ckpt_path: str) -> str:
    """The run id of the run that wrote a checkpoint: checkpoints live in
    ``{run_dir}/checkpoints/{name}``, so the ``checkpoints`` component is
    stepped over where it is there."""
    parts = ckpt_path.split(os.path.sep)
    idx = -3 if "checkpoints" in parts else -2
    return get_run_id_from_log_dir(parts[idx])
