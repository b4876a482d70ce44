"""Starting the ranks of a multi-card run: one process a device.

``launch(fn, world_size, args, device=...)`` runs ``fn(*args)`` on every
rank, inside a process group:

* inside a rank already (a process group is initialised), ``fn`` just
  runs;
* under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in the
  environment), this process joins the group from that environment
  (``env://``) and runs ``fn``;
* with a world size of 1 and no group, ``fn`` runs in this process, with
  no group;
* otherwise it starts the ``world_size`` processes itself with
  ``torch.multiprocessing.spawn`` (which imports the module that defines
  ``fn`` in each), over a ``FileStore`` in a fresh temporary directory
  unless ``init_method`` names another rendezvous.

Each rank first takes its own card (``torch.cuda.set_device``; card
``devices[local_rank]``, by default the local rank), so the port's
``resolve_device(None)`` names it. The backend is NCCL for a CUDA device
and gloo for the CPU; ``backend="gloo"`` on CUDA tensors is allowed (their
collectives go through the host), and only it may put several ranks on
one card. Nothing falls back: NCCL missing raises, more ranks than cards
raises, and a rank that fails ends the whole run with its exception
(``spawn`` stops the other ranks and raises in the parent).
"""
import os
import shutil
import tempfile
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike


def default_backend(device: DeviceLike) -> str:
    """NCCL for a CUDA device (None is the card), gloo for the CPU."""
    device = torch.device("cuda" if device is None else device)
    return "nccl" if device.type == "cuda" else "gloo"


def in_rank() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def torchrun_env() -> bool:
    """Whether torchrun's environment names this process's rank."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE"))


def world_size(config, device: DeviceLike) -> int:
    """The ranks of a run of mesh ``config`` (``mesh.MeshConfig``):
    ``data * model``, where ``data=None`` is every card present (every
    rank of torchrun's or of the group this process is in), and 1 on the
    CPU."""
    model = config.model_axis_size
    data = config.data_axis_size
    if data is None:
        if in_rank():
            data = dist.get_world_size() // model
        elif torchrun_env():
            data = int(os.environ["WORLD_SIZE"]) // model
        elif torch.device("cuda" if device is None
                          else device).type == "cuda":
            # no card at all: one rank, which then finds none
            data = max(1, torch.cuda.device_count() // model)
        else:
            data = 1
    if data < 1 or model < 1:
        raise ValueError(f"no {data} x {model} (data x model) layout: "
                         f"--num_devices and --model_devices must be >= 1")
    return data * model


def check_world(world_size: int, device: DeviceLike,
                backend: Optional[str] = None,
                devices: Optional[Sequence[int]] = None) -> None:
    """Raise where ``world_size`` ranks cannot run on ``device``: NCCL
    missing for a CUDA run, more ranks than cards (or cards named that are
    not there), two ranks on one card over NCCL."""
    backend = backend or default_backend(device)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this torch; a CUDA run "
                           "over several cards needs it")
    if torch.device("cuda" if device is None else device).type != "cuda":
        return
    cards = torch.cuda.device_count()
    used = list(devices) if devices is not None else list(range(world_size))
    if len(used) != world_size:
        raise ValueError(f"{len(used)} cards named for {world_size} ranks")
    if any(i < 0 or i >= cards for i in used):
        raise RuntimeError(f"{world_size} ranks on cards {used}, but "
                           f"{cards} card(s) are present")
    if backend == "nccl" and len(set(used)) != len(used):
        raise ValueError("NCCL takes one rank a card; put several ranks on "
                         "one card only over gloo")


def _rank(local_rank: int, fn: Callable, args: tuple, rank: int,
          world_size: int, init_method: str, backend: str,
          device: DeviceLike, devices: Optional[Sequence[int]]) -> Any:
    if torch.device("cuda" if device is None else device).type == "cuda":
        torch.cuda.set_device(devices[local_rank] if devices is not None
                              else local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def _spawned(local_rank: int, fn, args, world_size, init_method, backend,
             device, devices) -> None:
    _rank(local_rank, fn, args, local_rank, world_size, init_method,
          backend, device, devices)


def launch(fn: Callable, world_size: int, args: tuple = (),
           device: DeviceLike = None, backend: Optional[str] = None,
           init_method: Optional[str] = None,
           devices: Optional[Sequence[int]] = None) -> Any:
    """Run ``fn(*args)`` on ``world_size`` ranks (module docstring).
    Returns ``fn``'s result where it ran in this process, else None."""
    if in_rank():
        return fn(*args)
    backend = backend or default_backend(device)
    if torchrun_env():
        world = int(os.environ["WORLD_SIZE"])
        if world != world_size:
            raise ValueError(f"torchrun started {world} ranks; the run "
                             f"asks for {world_size}")
        local = int(os.environ.get("LOCAL_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        check_world(local_world, device, backend, devices)
        return _rank(local, fn, args, int(os.environ["RANK"]), world,
                     "env://", backend, device, devices)
    if world_size == 1:
        return fn(*args)
    check_world(world_size, device, backend, devices)
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="pv2c-dist-")
        init_method = "file://" + os.path.join(tmp, "store")
    try:
        torch.multiprocessing.spawn(
            _spawned, args=(fn, args, world_size, init_method, backend,
                            device, devices),
            nprocs=world_size, join=True)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return None
