"""The ``data`` x ``model`` layout of a multi-card run (the JAX package's
``parallel/mesh.py``), over one process per device.

The JAX package shards arrays over a device mesh inside one program; the
port runs one process a card, as PyTorch does (NCCL refuses two ranks on
one GPU), and every rank does what the JAX package's several-host branch
does: it takes its own rows of the global batch. Rank ``r`` sits at
``(r // model, r % model)`` of the mesh, the JAX package's
``devices[:data * model].reshape(data, model)``. :class:`Mesh` holds this
rank's place and two process groups: ``data`` (the ranks with its model
index) and ``model`` (the ranks with its data index).

Data parallelism. :func:`shard_batch` gives a rank its rows of a batch
whose leading dim divides by ``data`` (a :class:`ShardedBatch`, which
carries its :class:`DataShard`); another batch stays whole on every rank,
as the JAX package replicates it. A flow's step on a sharded batch makes
the numbers of the whole batch, as GSPMD does:

* the models run on the rank's rows, BatchNorm in training with the
  statistics of the global batch (:func:`global_moments`: the sums, the
  sums of squares and the count all-reduced over ``data``, under autograd);
* the losses are computed on the global batch: the flow's outputs and
  targets are all-gathered over ``data`` (:func:`gather_rows`), this
  rank's rows keeping their autograd history and the others' coming in
  detached, so a masked loss divides by the global count of valid joints
  and a summed loss sums the global batch. Each rank's backward then
  gives its rows' share of the global gradient, and the sum of the shares
  over ``data`` (:func:`all_reduce_`) is the gradient of the whole batch,
  which global-norm clipping then sees;
* metric states are summed over ``data`` before they are computed
  (``metrics/base.py::MetricCollection.all_reduce``).

Tensor parallelism. :func:`param_spec` is the JAX package's rule in the
port's layout: a parameter that is a 2-D kernel in the JAX package, of at
least ``_TP_MIN_SIZE`` elements, is sharded on the JAX kernel's last
(output) dim over ``model`` where that dim divides; everything else is
replicated. :func:`shard_state` gives each rank its slice of those
parameters as the optimizer's parameter, so that a rank keeps and updates
only its slice and the slice's AdamW moments (AdamW is elementwise: a
slice updates as the whole would); the whole weight stays in the state's
parameter dict, and after each update the ``model`` group all-gathers the
slices into it (:class:`ModelShards`), so every forward, and every kernel,
sees whole weights, as the Pallas custom calls do under GSPMD.
Checkpoints hold the whole state (:meth:`ModelShards.whole_optimizer_state`).

Random draws: a rank draws its dropout masks for its own rows from the
flow's generator, which has the same seed on every rank; the one-device
run draws one mask for the whole batch, so the masks differ (the parity
checks run without dropout). The datamodule makes (and augments) the
global batch on every rank, and the rank then takes its rows, so the data
is the one-device run's.
"""
import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshConfig:
    """Mesh layout: ``data`` x ``model`` axes. ``data_axis_size=None`` uses
    every device (process) for data parallelism."""
    data_axis_size: Optional[int] = None
    model_axis_size: int = 1

    def axis_sizes(self, num_devices: int):
        model = self.model_axis_size
        data = self.data_axis_size or (num_devices // model)
        return data, model


class Mesh:
    """This rank's place in the ``data`` x ``model`` layout and its two
    process groups (module docstring)."""

    def __init__(self, data: int, model: int, rank: int,
                 data_group, model_group, backend: str):
        self.data, self.model = data, model
        self.rank = rank
        self.data_rank, self.model_rank = divmod(rank, model)
        self.data_group, self.model_group = data_group, model_group
        self.backend = backend

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes logs and checkpoints."""
        return self.rank == 0

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, "
                f"rank={self.rank}, backend={self.backend!r})")


def make_mesh(config: MeshConfig = MeshConfig()) -> Mesh:
    """The mesh of the current process group (every rank calls it, in the
    same order as its other collectives): ``config.axis_sizes`` of the
    world size, which must be ``data * model``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the "
                           "ranks with parallel.launch or torchrun")
    world = dist.get_world_size()
    data, model = config.axis_sizes(world)
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"a {data} x {model} (data x model) mesh needs "
                         f"{data * model} processes; the group has {world}")
    rank = dist.get_rank()
    data_group = model_group = None
    # every rank creates every group, in one order
    for m in range(model):
        group = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = group
    for d in range(data):
        group = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = group
    return Mesh(data, model, rank, data_group, model_group,
                dist.get_backend())


# -- tensor parallelism --------------------------------------------------------

#: tensor-shard a kernel over ``model`` only when it is at least this big
#: (the JAX package's threshold)
_TP_MIN_SIZE = 4096
#: the projections of flax's ``MultiHeadDotProductAttention``, whose
#: kernels are 3-D there (``models/jax_import.py``): never sharded
_ATTENTION = ("query", "key", "value", "out")


def param_spec(name: str, x: torch.Tensor, model_axis_size: int
               ) -> Optional[int]:
    """The dim of the port's leaf ``name`` (a key of a model's parameter
    dict) to shard over ``model``, or None to replicate it: the JAX
    package's ``param_spec`` read through ``models/jax_import.py``. A
    2-D ``*.weight`` is a flax Dense kernel transposed to nn.Linear's
    (out, in), whose JAX last dim is dim 0 here (an attention projection's
    weight, 3-D in flax, is left whole); any other 2-D leaf keeps flax's
    layout, so its last dim is dim 1. The leaf is sharded when that dim
    divides by ``model_axis_size`` and it has at least ``_TP_MIN_SIZE``
    elements."""
    if model_axis_size <= 1 or x.ndim != 2 or x.numel() < _TP_MIN_SIZE:
        return None
    parts = name.split(".")
    if parts[-1] == "weight":
        if len(parts) >= 3 and parts[-2] in _ATTENTION \
                and parts[-3].startswith("MultiHeadDotProductAttention"):
            return None
        dim = 0
    else:
        dim = 1
    return dim if x.shape[dim] % model_axis_size == 0 else None


#: AdamW's per-element moments, sliced with their parameter
_MOMENTS = ("exp_avg", "exp_avg_sq")


class ModelShards:
    """The model-sharded leaves of a training state on this rank: for each,
    the whole tensor (in the state's parameter dict, which the forward
    reads), this rank's slice (the optimizer's parameter) and the dim."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        #: (name, whole, slice, dim)
        self.entries: List[tuple] = []

    def _local(self, whole: torch.Tensor, dim: int) -> torch.Tensor:
        size = whole.shape[dim] // self.mesh.model
        return whole.narrow(dim, self.mesh.model_rank * size, size)

    def _local_moments(self, st: Dict[str, Any], dim: int
                       ) -> Dict[str, Any]:
        return {k: self._local(v, dim).clone() if k in _MOMENTS else v
                for k, v in st.items()}

    @torch.no_grad()
    def refresh(self) -> None:
        """Each slice from its whole tensor (after a restore wrote the whole
        ones)."""
        for _, whole, part, dim in self.entries:
            part.copy_(self._local(whole, dim))

    @torch.no_grad()
    def slice_gradients(self) -> None:
        """Each slice's gradient from its whole tensor's, after the data
        all-reduce and the clipping."""
        for _, whole, part, dim in self.entries:
            part.grad = None if whole.grad is None \
                else self._local(whole.grad, dim).clone()

    def _gather(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        pieces = [torch.empty_like(part) for _ in range(self.mesh.model)]
        dist.all_gather(pieces, part.contiguous(),
                        group=self.mesh.model_group)
        return torch.cat(pieces, dim=dim)

    @torch.no_grad()
    def gather_parameters(self) -> None:
        """After an update: the ``model`` group all-gathers the slices into
        the whole tensors."""
        for _, whole, part, dim in self.entries:
            whole.copy_(self._gather(part, dim))

    def whole_optimizer_state(self, optimizer) -> Dict[str, Any]:
        """``optimizer.state_dict()`` with each sharded leaf's moments
        gathered whole: the state dict of the same optimizer on one
        device (every rank of the group calls it)."""
        sd = optimizer.state_dict()
        index = _param_index(optimizer)
        for _, _, part, dim in self.entries:
            st = sd["state"].get(index[id(part)])
            if st:  # a copy: the dict is the optimizer's own
                sd["state"][index[id(part)]] = {
                    k: self._gather(v, dim) if k in _MOMENTS else v
                    for k, v in st.items()}
        return sd

    def load_whole_optimizer_state(self, optimizer,
                                   sd: Dict[str, Any]) -> None:
        """Load a whole optimizer state dict (:meth:`whole_optimizer_state`,
        or a one-device run's), each sharded leaf's moments sliced."""
        index = _param_index(optimizer)
        sd = {**sd, "state": dict(sd["state"])}
        for _, _, part, dim in self.entries:
            st = sd["state"].get(index[id(part)])
            if st:
                sd["state"][index[id(part)]] = self._local_moments(st, dim)
        optimizer.load_state_dict(sd)


def _param_index(optimizer) -> Dict[int, int]:
    """id(parameter) -> its index in ``optimizer.state_dict()``."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {id(p): i for i, p in enumerate(params)}


def shard_state(mesh: Optional[Mesh], state):
    """Give ``state`` (a flow's ``FlowState``) the tensor-parallel layout
    of ``mesh``: each trained leaf that :func:`param_spec` shards gets this
    rank's slice as the optimizer's parameter, with its AdamW moments
    sliced where they exist (``state.sharding``, a :class:`ModelShards`).
    A state sharded already has its slices refreshed from the whole
    tensors. Without a mesh, or with ``model == 1``, the state is left
    as it is."""
    if getattr(state, "sharding", None) is not None:
        state.sharding.refresh()
        return state
    if mesh is None or mesh.model == 1:
        return state
    sharding, swap = ModelShards(mesh), {}
    for model_name, tree in state.params.items():
        for key, whole in tree.items():
            dim = param_spec(key, whole, mesh.model) \
                if whole.requires_grad else None
            if dim is not None:
                part = sharding._local(whole.detach(), dim).clone() \
                    .requires_grad_(True)
                sharding.entries.append((f"{model_name}.{key}", whole, part,
                                         dim))
                swap[id(whole)] = part
    opt = state.optimizer
    for group in opt.param_groups:
        group["params"] = [swap.get(id(p), p) for p in group["params"]]
    for _, whole, part, dim in sharding.entries:
        st = opt.state.pop(whole, None)
        if st:
            opt.state[part] = sharding._local_moments(st, dim)
    state.sharding = sharding
    return state


# -- data parallelism ----------------------------------------------------------

class DataShard(NamedTuple):
    """A batch's split over ``data``: the mesh and this rank's rows."""
    mesh: Mesh
    rows: int


class ShardedBatch(tuple):
    """This rank's rows of a batch (``(inputs, targets, meta)``), with the
    :class:`DataShard` they came from as ``shard``."""

    def __new__(cls, items: Iterable, shard: DataShard):
        out = super().__new__(cls, items)
        out.shard = shard
        return out


def batch_spec(mesh: Mesh, x) -> Optional[str]:
    """``"data"`` where ``x``'s leading dim splits over ``data``, None
    where ``x`` is replicated (a scalar, or a dim that does not divide)."""
    if getattr(x, "ndim", 0) >= 1 and x.shape[0] % mesh.data == 0:
        return "data"
    return None


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Optional[Mesh], batch):
    """This rank's rows of ``batch`` (a tuple ``(inputs, targets, meta)``
    of tensors, numpy arrays and dicts of them), as the JAX package's
    several-host branch takes them: where the inputs' leading dim ``B``
    splits over ``data`` (:func:`batch_spec`), rank ``d`` of it takes
    rows ``[d B / data, (d + 1) B / data)`` of every tensor and array with
    ``B`` leading rows, and the result is a :class:`ShardedBatch`; other
    leaves (and a batch whose ``B`` does not divide, which every rank
    then runs whole) are left whole. Without a mesh the batch is as it
    is."""
    if mesh is None or isinstance(batch, ShardedBatch):
        return batch
    B = batch[0].shape[0]
    if batch_spec(mesh, batch[0]) is None:
        return batch
    rows = B // mesh.data
    start = mesh.data_rank * rows

    def take(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1 \
                and x.shape[0] == B:
            return x[start:start + rows]
        return x
    return ShardedBatch(_map(take, tuple(batch)), DataShard(mesh, rows))


def data_shard(batch) -> Optional[DataShard]:
    """The :class:`DataShard` of a sharded batch, None for a whole one."""
    return getattr(batch, "shard", None)


_ACTIVE: List[DataShard] = []


@contextlib.contextmanager
def data_parallel(shard: Optional[DataShard]):
    """Within it, BatchNorm in training takes the statistics of the global
    batch of ``shard`` (a no-op context for None)."""
    if shard is None:
        yield
        return
    _ACTIVE.append(shard)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_shard() -> Optional[DataShard]:
    """The :class:`DataShard` of the step running, where it splits a batch
    over more than one rank."""
    if _ACTIVE and _ACTIVE[-1].mesh.data > 1:
        return _ACTIVE[-1]
    return None


class _AllReduceSum(torch.autograd.Function):
    """A sum over ``group`` whose backward is the sum of the ranks'
    cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def global_moments(x: torch.Tensor, axes, shard: DataShard):
    """The mean and flax's fast variance (``mean(x^2) - mean(x)^2``,
    clipped at 0) over ``axes`` of the global batch whose rows ``x`` are
    this rank's share: the sums, the sums of squares and the count
    all-reduced over ``data``, differentiably (the all-reduce's backward
    sums the ranks' cotangents)."""
    features = x.shape[[d for d in range(x.ndim) if d not in axes][0]]
    count = x.new_full((1,), x.numel() // features)
    stats = torch.cat([x.sum(axes), (x * x).sum(axes), count])
    stats = _AllReduceSum.apply(stats, shard.mesh.data_group)
    total = stats[-1]
    mean = stats[:features] / total
    var = torch.clamp(stats[features:2 * features] / total - mean * mean,
                      min=0.0)
    return mean, var


def _gather_tensor(t: torch.Tensor, shard: DataShard) -> torch.Tensor:
    mesh = shard.mesh
    send = t.detach()
    if send.dtype == torch.bool:  # gloo has no bool collectives
        send = send.to(torch.uint8)
    pieces = [torch.empty_like(send) for _ in range(mesh.data)]
    dist.all_gather(pieces, send.contiguous(), group=mesh.data_group)
    pieces = [p.to(t.dtype) for p in pieces]
    pieces[mesh.data_rank] = t
    return torch.cat(pieces)


def gather_rows(tree, shard: Optional[DataShard]):
    """Every tensor of ``tree`` (dicts, lists and tuples of tensors) with
    ``shard.rows`` leading rows -> the global batch's, the ranks' rows in
    rank order along dim 0; this rank's rows keep their autograd history,
    the others' come in detached. The tree as it is without a shard, or
    over one rank."""
    if shard is None or shard.mesh.data == 1:
        return tree

    def gather(x):
        if isinstance(x, torch.Tensor) and x.ndim >= 1 \
                and x.shape[0] == shard.rows:
            return _gather_tensor(x, shard)
        return x
    return _map(gather, tree)


@torch.no_grad()
def all_reduce_(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group``, in place, through one flat buffer
    a dtype (one collective each)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


@torch.no_grad()
def replicate(mesh: Optional[Mesh], tree):
    """Broadcast every tensor of ``tree`` (dicts of tensors) from rank 0 to
    every rank, in place; returns the tree."""
    if mesh is None:
        return tree
    leaves: List[torch.Tensor] = []
    _map(lambda x: leaves.append(x) if isinstance(x, torch.Tensor) else x,
         tree)
    for t in leaves:
        buf = t.detach().contiguous()
        dist.broadcast(buf, src=0)
        if buf.data_ptr() != t.data_ptr():
            t.detach().copy_(buf)
    return tree
