"""The resident epoch: K training steps over a device-resident subset.

A step is the datamodule's gather (``Hdf5DataModule.resident_scan_inputs``:
batch ``b``'s rows, preprocessed with the batch's own seed), then the
flow's ``backward_step`` (forward, losses, backward, clipping), the
schedules' lrs (:func:`~..flows.base.set_lrs`, on the host) and the AdamW
step: the parts of ``training_step``, in its order, so a resident epoch
takes the same steps as per-batch iteration over the same batches.

On the card the steps are CUDA graphs, replayed once a batch: one graph
of gather -> forward -> losses -> backward -> clipping, one of the AdamW
update. Between the two replays the host sets each scheduled group's lr
(a device tensor of the capturable AdamW, ``models/base.py::
set_capturable``); before the first it writes the batch index into the
tensor the gather reads and re-seeds the batch's preprocessing generator.
The flow's dropout generator and the preprocessing generator are
registered with the first graph, so each replay draws where the eager
step would. The first ``WARMUP_STEPS`` steps run eagerly, as the epoch's
own steps (they create AdamW's moments and the libraries' lazy state);
the graphs are captured after them, which launches nothing. A capture or a
replay that fails raises: nothing goes quietly to the eager route.

The kernel wrappers count their launches on the host
(``ops/cuda_build.py::COUNTED``), so under capture they would count once.
The runner takes their counts' growth during capture as the kernels a
replay launches, takes it back, and adds it times the replays at the end
of each call.

On the CPU (``graphs=False``, and the only choice there) the same steps
run eagerly.

In a multi-card run (``mesh``, ``parallel/mesh.py``) each step takes this
rank's rows of the gathered batch (``shard_batch``: the batch is gathered
and preprocessed whole, so its draws are the one-device run's), and the
step's collectives (the gradient all-reduce over ``data``, the slices'
all-gather over ``model``) run inside the steps. Over an NCCL group the
graphs capture them (NCCL allows it; the eager warm-up steps create the
communicators first). A gloo group cannot be captured: over one the
runner takes the eager route, and ``graphs=True`` raises.
"""
from typing import Dict, Optional, Tuple

import torch

from ..data.base.datamodule import batch_seed
from ..flows.base import optimizer_step, set_lrs
from ..models.base import set_capturable
from ..ops.cuda_build import COUNTED
from ..parallel.mesh import Mesh, shard_batch


_COUNTERS = ("launches", "bf16_launches")
#: the eager steps of an epoch before its capture
WARMUP_STEPS = 2


def _counts() -> Dict[Tuple[str, str], int]:
    return {(name, c): getattr(fn, c) for name, fn in COUNTED.items()
            for c in _COUNTERS if hasattr(fn, c)}


def _add_counts(delta: Dict[Tuple[str, str], int], times: int) -> None:
    for (name, c), n in delta.items():
        fn = COUNTED[name]
        setattr(fn, c, getattr(fn, c) + times * n)


class ResidentRunner:
    """Runs ``k`` consecutive training steps of ``flow`` over the resident
    subset of ``spec`` (module docstring): ``runner(state, b0, k) ->
    (state, logs, lrs)``, the logs of each step stacked along a first axis
    of ``k`` on the device, and each step's lrs (``lr-<group>``) as host
    floats. ``graphs`` defaults to True on the card; the CPU takes only
    False, and so does a gloo ``mesh``. :meth:`set_epoch` hands over the
    next epoch's spec; a new state (or a restored optimizer) is captured
    anew."""

    def __init__(self, flow, spec, graphs: Optional[bool] = None,
                 mesh: Optional[Mesh] = None):
        device = spec.order.device
        gloo = mesh is not None and mesh.backend == "gloo"
        if graphs and gloo:
            raise ValueError("a gloo group's collectives cannot be captured "
                             "in a CUDA graph; the resident epoch runs "
                             "eagerly over gloo")
        self.graphs = device.type == "cuda" and not gloo \
            if graphs is None else graphs
        if self.graphs and device.type != "cuda":
            raise ValueError("CUDA graphs need the subset on a CUDA device")
        self.mesh = mesh
        self.flow = flow
        self.device = device
        self.warmup = WARMUP_STEPS
        self.gather, self.trees = spec.gather, spec.trees
        self.num_batches = spec.num_batches
        self.stream = spec.stream
        #: the tensors a graph reads: the epoch's order, the batch index
        self.order = spec.order.clone()
        self.index = torch.zeros(1, dtype=torch.int64, device=device)
        self.generator = torch.Generator(device=device) \
            if spec.draws else None
        #: the graphs' kernel launches per replay, by (wrapper, counter)
        self.captured: Dict[Tuple[str, str], int] = {}
        #: replays of the first graph so far
        self.replays = 0
        self._signature = None
        self._side = None

    def set_epoch(self, spec) -> None:
        """The next epoch over the same resident subset: its order and
        seed stream."""
        if spec.trees is not self.trees and any(
                a is not b for a, b in zip(spec.trees, self.trees)):
            raise ValueError("set_epoch: another subset than the runner's")
        if spec.order.shape != self.order.shape:
            raise ValueError("set_epoch: the epoch's order changed length")
        self.order.copy_(spec.order)
        self.stream = spec.stream

    # -- the step ----------------------------------------------------------
    def _batch(self):
        return shard_batch(self.mesh, self.gather(
            self.generator, self.order, self.index, *self.trees))

    def _start(self, b: int) -> None:
        """What the host does before a step: the batch index on the device
        and the batch's preprocessing seed."""
        self.index.fill_(b)
        if self.generator is not None:
            self.generator.manual_seed(batch_seed(self.stream, b))

    def _eager(self, state, b: int):
        self._start(b)
        logs = self.flow.backward_step(state, self._batch())
        vec = torch.stack(list(logs.values()))
        lrs = set_lrs(state, logs["train_loss/primary"])
        optimizer_step(state)
        state.step += 1
        return list(logs), vec, lrs

    def _replay(self, state, b: int):
        self._start(b)
        self._g1.replay()
        lrs = set_lrs(state, self._logs["train_loss/primary"])
        self._g2.replay()
        state.step += 1
        self.replays += 1
        return list(self._logs), self._vec.clone(), lrs

    def _capture(self, state) -> None:
        before = _counts()
        pool = torch.cuda.graph_pool_handle()
        g1, g2 = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        for gen in (self.generator, getattr(self.flow, "generator", None)):
            if gen is None or gen.device.type != "cuda":
                continue
            if not hasattr(g1, "register_generator_state"):
                raise RuntimeError(
                    "this torch has no CUDAGraph.register_generator_state: "
                    "a graph would replay the random draws of its capture")
            g1.register_generator_state(gen)
        torch.cuda.synchronize()
        with torch.cuda.graph(g1, pool=pool,
                              capture_error_mode="thread_local"):
            self._logs = self.flow.backward_step(state, self._batch())
            self._vec = torch.stack(list(self._logs.values()))
        with torch.cuda.graph(g2, pool=pool,
                              capture_error_mode="thread_local"):
            optimizer_step(state)
        torch.cuda.synchronize()
        after = _counts()
        self.captured = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        _add_counts(self.captured, -1)  # capture launched nothing
        self._g1, self._g2 = g1, g2

    @staticmethod
    def _signature_of(state) -> tuple:
        """The identity of every tensor of the state that a graph holds
        besides the parameters (which a restore writes in place)."""
        opt = state.optimizer
        return (id(state), id(opt), tuple(
            id(g["lr"]) for g in opt.param_groups), tuple(
            id(t) for st in opt.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)))

    def _prepare(self, state) -> None:
        """A new state, or a new optimizer state, drops the graphs."""
        if self.device.type == "cuda":
            set_capturable(state.optimizer, True)
        if self._signature_of(state) != self._signature:
            self._g1 = self._g2 = None
            self._eager_steps = 0
            self._fixed_lrs = {f"lr-{g['name']}": float(g["lr"])
                               for g in state.optimizer.param_groups
                               if g["name"] not in state.schedules}

    def __call__(self, state, b0: int, k: int):
        if b0 < 0 or b0 + k > self.num_batches:
            raise IndexError(f"batches [{b0}, {b0 + k}) of "
                             f"{self.num_batches}")
        self._prepare(state)
        keys, rows, lrs = None, [], []
        replays = self.replays
        for b in range(b0, b0 + k):
            if self.graphs and self._g1 is None \
                    and self._eager_steps >= self.warmup:
                self._capture(state)
            if self._g1 is not None:
                keys, vec, step_lrs = self._replay(state, b)
            elif self.graphs:
                # the warm-up steps run on a side stream, as the recipe of
                # CUDA graphs has them
                if self._side is None:
                    self._side = torch.cuda.Stream(self.device)
                main = torch.cuda.current_stream(self.device)
                self._side.wait_stream(main)
                with torch.cuda.stream(self._side):
                    keys, vec, step_lrs = self._eager(state, b)
                main.wait_stream(self._side)
                self._eager_steps += 1
            else:
                keys, vec, step_lrs = self._eager(state, b)
                self._eager_steps += 1
            # the first step creates AdamW's moments
            self._signature = self._signature_of(state)
            rows.append(vec)
            lrs.append({name: step_lrs.get(name, self._fixed_lrs.get(name))
                        for name in (f"lr-{g['name']}" for g in
                                     state.optimizer.param_groups)})
        _add_counts(self.captured, self.replays - replays)
        stacked = torch.stack(rows) if rows else None
        logs = {key: stacked[:, i] for i, key in enumerate(keys or [])}
        return state, logs, lrs


def build_scan_runner(flow, spec, graphs: Optional[bool] = None,
                      mesh: Optional[Mesh] = None) -> ResidentRunner:
    """The runner of ``flow``'s steps over the resident epoch ``spec``
    (:class:`ResidentRunner`), on this rank's rows of ``mesh``."""
    return ResidentRunner(flow, spec, graphs=graphs, mesh=mesh)
