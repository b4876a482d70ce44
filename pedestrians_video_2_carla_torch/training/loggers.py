"""Scalar, hparam and video logging, the layout of the JAX package's
loggers: ``metrics.jsonl`` (one JSON record per call, ``{"step", "time",
**scalars}``), ``hparams.json``, TensorBoard events under ``tb/`` where
``torch.utils.tensorboard`` imports, and with ``WandbOfflineLogger`` a
W&B offline run directory's files."""
import json
import math
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, log_dir: str, enabled: bool = True):
        #: ``enabled=False`` writes nothing (a process that is not the
        #: first of a multi-process run)
        self.enabled = enabled
        self.log_dir = log_dir
        self._tb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))
        except Exception:
            pass

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        """Append one record to ``metrics.jsonl`` (the file is open only
        for the write); the numbers also go to TensorBoard."""
        if not self.enabled:
            return
        record = {"step": step, "time": time.time(), **scalars}
        with open(os.path.join(self.log_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
            # wait for the writer's thread: without TensorFlow it appends
            # to the event file by path, so a write still queued when the
            # caller removes the log directory would make the file anew
            self._tb.flush()

    def log_video(self, tag: str, video, step: int, fps: float = 30.0
                  ) -> None:
        """A rendered (T, H, W, C) uint8 clip to TensorBoard; skipped when
        TensorBoard, or the moviepy its video encoder needs, is missing."""
        if not self.enabled or self._tb is None:
            return
        import importlib.util
        if importlib.util.find_spec("moviepy") is None:
            return
        try:
            import numpy as np
            import torch
            vid = torch.from_numpy(
                np.ascontiguousarray(video)).permute(0, 3, 1, 2)[None]
            self._tb.add_video(tag, vid, global_step=step, fps=int(fps))
            self._tb.flush()
        except Exception:
            pass

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        """Merge ``hparams`` into ``hparams.json``."""
        if not self.enabled:
            return
        path = os.path.join(self.log_dir, "hparams.json")
        existing = {}
        if os.path.exists(path):
            with open(path) as f:
                existing = json.load(f)
        existing.update({k: _jsonable(v) for k, v in hparams.items()})
        with open(path, "w") as f:
            json.dump(existing, f, indent=1)

    def close(self):
        if self._tb is not None:
            self._tb.close()


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


def yaml_text(value) -> str:
    """``value`` (dicts, lists, strings, numbers, booleans, None) as YAML
    in flow style without PyYAML: JSON, but with each float written so
    that a YAML 1.1 reader (PyYAML's ``safe_load``) reads it back as a
    float (``1.0e-08``, not ``1e-08``; ``.nan``, ``.inf``)."""
    if isinstance(value, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {yaml_text(v)}"
                               for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(yaml_text(v) for v in value) + "]"
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = float.__repr__(value)
        if "e" in text and "." not in text:
            mantissa, exponent = text.split("e")
            text = f"{mantissa}.0e{exponent}"
        return text
    return json.dumps(value)


class WandbOfflineLogger(MetricsLogger):
    """A W&B offline run directory's files, written without the ``wandb``
    package and without a network:

        {log_dir}/wandb/offline-run-{YYYYMMDD_HHMMSS}-{run_id}/files/
            config.yaml           # {key: {value: ...}}
            wandb-metadata.json   # program, arguments, start
            wandb-summary.json    # the latest value of each metric
            wandb-history.jsonl   # one row a step (_step, _timestamp)

    ``config.yaml`` is written without PyYAML (``yaml_text``), so that the
    logger runs where PyYAML is missing; ``yaml.safe_load`` reads it as
    the JAX package's. Scalars and hparams also go to the
    ``MetricsLogger`` files."""

    def __init__(self, log_dir: str, enabled: bool = True,
                 run_id: str = "run", project: str = "pv2c",
                 entity: str = "carla-pedestrians", argv=None):
        super().__init__(log_dir, enabled=enabled)
        self._summary: Dict[str, Any] = {}
        self._config: Dict[str, Any] = {}
        self._files = None
        if not enabled:
            return
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self._files = os.path.join(
            log_dir, "wandb", f"offline-run-{stamp}-{run_id}", "files")
        os.makedirs(self._files, exist_ok=True)
        meta = {
            "run_id": run_id, "project": project, "entity": entity,
            "program": argv[0] if argv else "pedestrians_video_2_carla_torch",
            "args": list(argv[1:]) if argv else [],
            "startedAt": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "mode": "offline",
        }
        with open(os.path.join(self._files, "wandb-metadata.json"),
                  "w") as f:
            json.dump(meta, f, indent=1)

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        super().log_scalars(step, scalars)
        if self._files is None:
            return
        row = {"_step": step, "_timestamp": time.time(),
               **{k: v for k, v in scalars.items()
                  if isinstance(v, (int, float))}}
        with open(os.path.join(self._files, "wandb-history.jsonl"),
                  "a") as f:
            f.write(json.dumps(row) + "\n")
        self._summary.update(row)
        with open(os.path.join(self._files, "wandb-summary.json"),
                  "w") as f:
            json.dump(self._summary, f)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        super().log_hparams(hparams)
        if self._files is None:
            return
        self._config.update({k: {"value": _jsonable(v)}
                             for k, v in hparams.items()})
        with open(os.path.join(self._files, "config.yaml"), "w") as f:
            f.write(yaml_text(self._config) + "\n")
