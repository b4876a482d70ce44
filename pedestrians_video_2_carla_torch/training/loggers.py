"""Scalar and hparam logging to files: ``metrics.jsonl`` (one JSON record
per call, ``{"step", "time", **scalars}``) and ``hparams.json``, the layout
of the JAX package's ``MetricsLogger``. TensorBoard, video and W&B logging
are not ported yet."""
import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        """Append one record to ``metrics.jsonl`` (the file is open only
        for the write)."""
        record = {"step": step, "time": time.time(), **scalars}
        with open(os.path.join(self.log_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        """Merge ``hparams`` into ``hparams.json``."""
        path = os.path.join(self.log_dir, "hparams.json")
        existing = {}
        if os.path.exists(path):
            with open(path) as f:
                existing = json.load(f)
        existing.update({k: _jsonable(v) for k, v in hparams.items()})
        with open(path, "w") as f:
            json.dump(existing, f, indent=1)


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)
