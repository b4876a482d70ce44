"""Training loop on one card: the flow's train step over a datamodule's
batches, validation with checkpointing on ``val_loss/primary``, and scalar
logging (the JAX package's ``training/trainer.py``, streamed epoch only).

A flow with a metric collection has its metrics accumulated over every
evaluation pass and logged beside the losses; a metric that no batch fed
is left out; classification metrics are also drawn as PNGs
(``training/plots.py``). A fit starts with the flow's baseline pass (its
initial metrics of its baseline predictions, over the validation set, into
``hparams.json``) unless ``skip_initial_metrics``, sets the flow's
``steps_per_epoch`` (for the LR schedules) from the data module before the
optimizer is built, and calls the flow's ``on_epoch_start`` before each
epoch. The port has no mesh. ``logger`` "wandb" also writes a W&B offline
run directory (``training/loggers.py``). A ``video_logger``
(``loggers/pedestrian_logger.py``) renders the first validation batch of
each evaluation and, at its throttle's steps, the training batch through
an extra evaluation forward; a rendering that fails is a warning, never
the end of the run.

An epoch takes one of two routes. Where the datamodule keeps its train
subset on the device (``resident_scan_inputs`` gives a spec) and no video
logger needs the training batches on the host, it runs as the resident
epoch (``runtime/resident_scan.py``): chunks of K =
``log_every_n_steps`` steps, on the card as CUDA graph replays, whose
per-step logs stay on the device until the chunk's log steps read them.
Otherwise the datamodule's batches stream through the background
prefetcher (``runtime/prefetcher.py``) into one ``training_step`` each:
its worker makes the host half of the next batches and copies and
finishes them on a side stream (``BaseDataModule.train_stream``).
Either way each log step logs its own values and lrs, and the host
synchronises once per log interval and once per evaluation pass;
evaluation iterates the batches one by one (resident ones too).
"""
import itertools
import json
import math
import os
import sys
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..flows.base import BaseFlow, FlowState
from ..models.torch_import import import_torch_checkpoint
from ..runtime.prefetcher import DevicePrefetcher, device_put
from ..runtime.resident_scan import build_scan_runner
from ..utils.device import DeviceLike, resolve_device
from .checkpoint import CheckpointManager
from .loggers import MetricsLogger, WandbOfflineLogger


@dataclass
class TrainerConfig:
    max_epochs: int = 1
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None
    limit_test_batches: Optional[int] = None
    log_every_n_steps: int = 50
    check_val_every_n_epoch: int = 1
    seed: int = 22742
    logs_dir: str = "outputs/logs"
    run_name: str = "run"
    #: leave out the fit-start baseline pass (its ``initial_*`` metrics)
    skip_initial_metrics: bool = False
    #: Lightning's --detect_anomaly: at every log interval, abort with a
    #: report if a logged loss or a parameter is not finite
    detect_anomaly: bool = False
    #: "auto" or "tensorboard": the ``MetricsLogger`` files (and TensorBoard
    #: where it imports); "wandb": a W&B offline run directory as well
    logger: str = "auto"
    #: the card unless the caller asks for the CPU (``"cpu"``); the flow and
    #: the datamodule must be on the same device
    device: DeviceLike = None


#: the loggers a ``TrainerConfig`` names
LOGGERS = ("auto", "tensorboard", "wandb")
#: batches the streamed epoch's prefetcher makes ahead
PREFETCH_DEPTH = 4


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar tensors -> floats, in one device->host copy."""
    if not tensors:
        return {}
    values = torch.stack([v.detach().float().reshape(())
                          for v in tensors.values()]).tolist()
    return dict(zip(tensors, values))


def _host_tree(tree):
    """A dict (or sequence) of tensors -> the same of numpy arrays on the
    host; other leaves, ``None`` among them, as they are."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _flatten_metrics(computed: Dict[str, Any], stage: str) -> Dict[str, Any]:
    """Computed metrics -> log entries: scalars as floats, curves and
    matrices as lists."""
    def host(v):
        return float(v) if v.ndim == 0 else v.tolist()
    out = {}
    for name, value in computed.items():
        if isinstance(value, dict):
            for k, v in value.items():
                out[f"{stage}_{name}/{k}"] = host(v)
        else:
            out[f"{stage}_{name}"] = host(value)
    return out


class Trainer:
    def __init__(self, flow: BaseFlow, datamodule, config: TrainerConfig,
                 video_logger=None):
        self.device = resolve_device(config.device)
        for name, obj in (("flow", flow), ("datamodule", datamodule)):
            if obj.device != self.device:
                raise ValueError(f"the {name} is on {obj.device}, the "
                                 f"trainer on {self.device}")
        self.flow = flow
        self.dm = datamodule
        self.config = config
        self.state: Optional[FlowState] = None
        self.log_dir = os.path.join(config.logs_dir, config.run_name)
        os.makedirs(self.log_dir, exist_ok=True)
        if config.logger not in LOGGERS:
            raise ValueError(f"unknown logger {config.logger!r}; one of "
                             f"{LOGGERS}")
        self.logger = WandbOfflineLogger(
            self.log_dir, run_id=config.run_name, argv=sys.argv) \
            if config.logger == "wandb" else MetricsLogger(self.log_dir)
        #: a ``PedestrianLogger`` or None
        self.video_logger = video_logger
        self.checkpoints = CheckpointManager(
            os.path.join(self.log_dir, "checkpoints"))
        #: the resident epoch's runner, kept across epochs
        self.runner = None

    def _init_state(self) -> None:
        if self.state is None:  # keep a state restored via --ckpt_path
            # the LR schedules count epochs in steps, so the epoch's length
            # goes to the flow before its optimizer is built, unless the
            # flow was given one
            if getattr(self.flow, "steps_per_epoch", None) == 1:
                spe = self._resolve_train_batches()
                if spe is None:
                    n = self.dm.train_set_size
                    if n and self.dm.batch_size:
                        spe = n // self.dm.batch_size
                if spe:
                    self.flow.steps_per_epoch = max(1, int(spe))
            self.state = self.flow.init_state()

    def _resolve_train_batches(self) -> Optional[int]:
        """Steps per epoch: ``limit_train_batches``, or for an infinite
        train stream four validation sets' worth of batches."""
        limit = self.config.limit_train_batches
        if limit is None and self.dm.uses_infinite_train_set():
            val_size = self.dm.val_set_size or self.dm.batch_size
            limit = int(math.ceil(4 * val_size / self.dm.batch_size))
        return limit

    # ------------------------------------------------------------------
    def fit(self) -> FlowState:
        self._init_state()
        counts = self.flow.param_counts(self.state)
        print("  | model      | params\n  " + "\n  ".join(
            f"| {k:<10} | {v:,}" for k, v in counts.items()))
        initial = {} if self.config.skip_initial_metrics \
            else self.initial_metrics()
        self.logger.log_hparams({
            **self.dm.hparams, **initial,
            **{f"params/{k}": v for k, v in counts.items()}})

        limit = self._resolve_train_batches()
        global_step = 0
        summary: Dict[str, Any] = {}
        for epoch in range(self.config.max_epochs):
            if self.flow.on_epoch_start(epoch):
                self.runner = None  # the graphs hold the old model
            epoch_start = time.perf_counter()
            spec = None
            spec_fn = getattr(self.dm, "resident_scan_inputs", None)
            if spec_fn is not None and self.video_logger is None:
                spec = spec_fn("train", shuffle=True, training=True,
                               seed=self.config.seed + epoch)
            if spec is not None:
                last_logs, global_step = self._fit_epoch_scanned(
                    spec, limit, global_step)
            else:
                last_logs, global_step = self._fit_epoch_streamed(
                    limit, global_step, epoch)
            # reading the last logs waits for the epoch's device work
            host_last = _to_host(last_logs) if last_logs is not None else {}
            summary = {"epoch": epoch,
                       "epoch_time_s": time.perf_counter() - epoch_start,
                       **host_last}
            if (epoch + 1) % self.config.check_val_every_n_epoch == 0:
                val_metrics = self.evaluate("val",
                                            self.config.limit_val_batches)
                summary.update(val_metrics)
                self.checkpoints.save(self.state, val_metrics,
                                      step=global_step)
            self.logger.log_scalars(global_step, summary)
        self.checkpoints.wait()
        return self.state

    def _fit_epoch_streamed(self, limit, global_step: int, epoch: int):
        """One train step per batch of the datamodule's stream, made
        ``PREFETCH_DEPTH`` batches ahead on the prefetcher's worker thread:
        the host half of each batch, then its copies and its device half
        on a side stream (``BaseDataModule.train_stream``). Only the latest
        step's logs are kept, on the device."""
        host, finish = self.dm.train_stream(self.config.seed + epoch)
        if limit is not None:
            host = itertools.islice(host, limit)
        if PREFETCH_DEPTH > 0:
            train_iter = DevicePrefetcher(
                host, put_fn=device_put(self.device, finish),
                depth=PREFETCH_DEPTH)
        else:
            train_iter = host if finish is None else map(finish, host)
        last_logs = None
        for batch_idx, batch in enumerate(train_iter):
            self.state, logs = self.flow.training_step(self.state, batch)
            global_step += 1
            last_logs = logs
            if global_step % self.config.log_every_n_steps == 0:
                host_logs = _to_host(logs)
                self.logger.log_scalars(
                    global_step,
                    {**host_logs, **self.flow.current_lrs(self.state)})
                if self.config.detect_anomaly:
                    self._check_anomaly(host_logs, global_step)
            if self.video_logger is not None \
                    and self.video_logger.should_log(global_step):
                self._log_videos(batch, None, global_step, batch_idx,
                                 "train")
        return last_logs, global_step

    def _fit_epoch_scanned(self, spec, limit, global_step: int):
        """The resident epoch: chunks of K = ``log_every_n_steps`` steps
        through the runner (module docstring). Each chunk's logs come back
        stacked on the device; the host reads them once, at a chunk with a
        log step, and logs each log step's own values and lrs (and runs
        ``--detect_anomaly`` on them)."""
        every = self.config.log_every_n_steps
        nb = spec.num_batches if limit is None \
            else min(limit, spec.num_batches)
        K = max(1, min(every, nb))
        if self.runner is None:
            self.runner = build_scan_runner(self.flow, spec)
        else:
            self.runner.set_epoch(spec)
        last_logs = None
        for b0 in range(0, nb, K):
            k = min(K, nb - b0)
            self.state, logs, lrs = self.runner(self.state, b0, k)
            hits = [j for j in range(k) if (global_step + j + 1) % every == 0]
            if hits:
                rows = torch.stack(list(logs.values()), dim=1).tolist()
                for j in hits:
                    step_logs = dict(zip(logs, rows[j]))
                    self.logger.log_scalars(global_step + j + 1,
                                            {**step_logs, **lrs[j]})
                    if self.config.detect_anomaly:
                        self._check_anomaly(step_logs, global_step + j + 1)
            global_step += k
            last_logs = {key: v[-1] for key, v in logs.items()}
        return last_logs, global_step

    def _check_anomaly(self, host_logs: Dict[str, float],
                       global_step: int) -> None:
        """--detect_anomaly: abort with a report when a logged loss or any
        parameter is not finite (a masked loss can look finite while the
        parameters are already NaN)."""
        bad_losses = [k for k, v in host_logs.items() if not math.isfinite(v)]
        bad_params = [f"{name}.{k}"
                      for name, tree in self.state.params.items()
                      for k, v in tree.items() if v.requires_grad
                      and not bool(torch.isfinite(v).all())]
        if not bad_losses and not bad_params:
            return
        report = {"step": global_step, "non_finite_losses": bad_losses,
                  "non_finite_params": bad_params[:50]}
        with open(os.path.join(self.log_dir, "anomaly.json"), "w") as f:
            json.dump(report, f, indent=1)
        raise RuntimeError(
            f"detect_anomaly: non-finite at step {global_step}: "
            f"losses={bad_losses} params={bad_params[:5]}"
            f"{'...' if len(bad_params) > 5 else ''} "
            f"(full report in {self.log_dir}/anomaly.json)")

    def _tb_video_callback(self, step: int):
        """Hands each rendered clip to the logger's TensorBoard channel
        too."""
        def cb(video, clip_idx, fps, stage, meta):
            self.logger.log_video(f"{stage}/video_{clip_idx}", video,
                                  step, fps)
        return cb

    def _log_videos(self, batch, outputs, step: int, batch_idx: int,
                    stage: str) -> None:
        """The video logger's clips of ``batch``, from the eval step's
        ``(preds, targets)`` in ``outputs`` (computed here when None, as
        for a training batch). A failure is a warning: the videos never
        end a run."""
        try:
            if outputs is None:
                _, preds, targets = self.flow.eval_step(self.state.params,
                                                        batch)
            else:
                preds, targets = outputs
            self.video_logger.log_videos(
                inputs=_host_tree(batch[0]), targets=_host_tree(targets),
                projections=_host_tree({k: v for k, v in preds.items()
                                        if v is not None}),
                meta=_host_tree(batch[2]), step=step, batch_idx=batch_idx,
                stage=stage, force=True,
                vid_callback=self._tb_video_callback(step))
        except Exception as e:
            warnings.warn(f"{stage} video logging failed: {e!r}")

    # ------------------------------------------------------------------
    def evaluate(self, stage: str = "val",
                 limit: Optional[int] = None) -> Dict[str, Any]:
        """``<stage>_loss/<name>`` averages over the val or test batches and
        ``<stage>_loss/primary`` (the flow's own ``primary`` entry, else its
        first requested loss mode); where the flow has a metric collection,
        ``<stage>_<Metric>`` as well (a scalar as a float, a curve or a
        matrix as a list, a dict-valued metric as
        ``<stage>_<Metric>/<key>``). Sums and metric states stay on the
        device; the host reads them once at the end."""
        self._init_state()
        batches = self.dm.val_batches() if stage == "val" \
            else self.dm.test_batches()
        if limit is not None:
            batches = itertools.islice(batches, limit)
        collection = getattr(self.flow, "metrics", None)
        mstate = collection.init_state(self.device) if collection else None
        loss_sums: Dict[str, torch.Tensor] = {}
        count = 0
        for batch in batches:
            loss_dict, preds, targets = self.flow.eval_step(
                self.state.params, batch)
            for k, v in loss_dict.items():
                loss_sums[k] = v if k not in loss_sums else loss_sums[k] + v
            if collection:
                mstate = collection.update(mstate, preds, targets)
            if count == 0 and self.video_logger is not None:
                self._log_videos(batch, (preds, targets),
                                 int(self.state.step), 0, stage)
            count += 1
        results: Dict[str, Any] = {}
        if count:
            for k, v in _to_host(loss_sums).items():
                results[f"{stage}_loss/{k}"] = v / count
            primary = next((f"{stage}_loss/{m.name}"
                            for m in self.flow.requested_loss_modes
                            if f"{stage}_loss/{m.name}" in results), None)
            if primary and f"{stage}_loss/primary" not in results:
                results[f"{stage}_loss/primary"] = results[primary]
            if collection:
                computed = collection.compute_moved(mstate, self.device)
                results.update(_flatten_metrics(computed, stage))
                self._save_plots(computed, stage)
        return results

    def _save_plots(self, computed: Dict[str, Any], stage: str) -> None:
        """The classification plots of an evaluation pass (none for other
        flows) under ``<log_dir>/plots``. Plotting never ends a run: a
        failure, matplotlib missing among them, is a warning."""
        if "ConfusionMatrix" not in computed:
            return

        def host(v):
            return {k: host(x) for k, x in v.items()} \
                if isinstance(v, dict) else v.detach().cpu().numpy()
        try:
            from .plots import save_classification_plots
            save_classification_plots(
                {k: host(v) for k, v in computed.items()},
                os.path.join(self.log_dir, "plots"), stage, self.state.step)
        except Exception as e:
            warnings.warn(f"classification plots failed: {e!r}")

    def initial_metrics(self) -> Dict[str, Any]:
        """``initial_<Metric>``: the flow's initial metrics over the
        validation set, with the inputs taken as the predictions
        (``flow.initial_preds``); empty for a flow without them."""
        collection = getattr(self.flow, "initial_metrics", None)
        if not collection:
            return {}
        mstate = collection.init_state(self.device)
        batches = 0
        for inputs, targets, _ in self.dm.val_batches():
            mstate = collection.update(
                mstate, self.flow.initial_preds(inputs, targets), targets)
            batches += 1
        if not batches:
            return {}
        return _flatten_metrics(collection.compute_moved(mstate, self.device),
                                "initial")

    def test(self) -> Dict[str, Any]:
        results = self.evaluate("test", self.config.limit_test_batches)
        self.logger.log_scalars(-1, results)
        return results

    def predict(self, set_name: str = "test") -> List[Tuple[Any, Any, Any]]:
        """The flow's eval step over ``dm.predict_batches(set_name)``: one
        ``(preds, targets, meta)`` of host numpy arrays per batch (a
        prediction the flow leaves out stays ``None``), as the JAX
        package's ``Trainer.predict`` gives them."""
        self._init_state()
        outputs = []
        for batch in self.dm.predict_batches(set_name):
            _, preds, targets = self.flow.eval_step(self.state.params, batch)
            outputs.append(tuple(_host_tree(t)
                                 for t in (preds, targets, batch[2])))
        return outputs

    def restore(self, path: str, weights_only: bool = False) -> None:
        """Load a checkpoint into the trainer's state; ``weights_only``
        keeps a fresh optimizer state and step count."""
        self._init_state()
        self.checkpoints.restore(self.state, path, weights_only=weights_only)

    def restore_torch(self, path: str, model_name: str) -> None:
        """Load a reference torch or Lightning checkpoint's movements-model
        weights (``LinearAE``, ``Seq2SeqEmbeddings``, ``VideoPose3D`` with
        its running statistics, ``PoseFormer``:
        ``models/torch_import.py``) into the trainer's state, in place; the
        optimizer state and the step count stay fresh, as in the JAX
        package's ``restore_torch``. Another model name, or a file that
        does not fit the flow's model, raises."""
        self._init_state()
        loaded = import_torch_checkpoint(path, model_name)
        tree = self.state.params.get("movements")
        if tree is None or set(loaded) != set(tree) or any(
                loaded[k].shape != v.shape for k, v in tree.items()):
            raise ValueError(
                f"{path}: {model_name}'s weights do not fit the flow's "
                f"movements model ({sorted(loaded)} against "
                f"{sorted(tree or {})})")
        with torch.no_grad():
            for k, v in tree.items():
                v.copy_(loaded[k])
