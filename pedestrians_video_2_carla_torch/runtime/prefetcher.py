"""Background prefetcher: a worker thread runs the batch source (the host
slicing of the next batches) and its ``put_fn`` (their host -> card
copies and preprocessing launches) while the consumer runs its steps,
through a bounded queue.

``device_put(device, finish)`` is the ``put_fn`` that moves a batch's CPU
tensors to a CUDA card and then runs ``finish`` on it (a datamodule's
device half, ``BaseDataModule.train_stream``): each tensor is copied from
pinned host memory on a side stream, ``finish`` launches its work on the
same stream, the consumer's stream waits on the stream's event when it
takes the batch, and ``record_stream`` keeps the caching allocator from
reusing the batch's memory before the consumer's stream is done with it.
Tensors already on the device pass through unchanged, as do whole batches
on the CPU (where ``finish`` runs on the worker too).
"""
import queue
import threading
from typing import Any, Callable, Iterator, List, Optional

import torch

from ..utils.device import DeviceLike


class _Staged:
    """A batch whose copies and launches are in flight on a side stream."""

    def __init__(self, batch: Any, event: torch.cuda.Event):
        self.batch, self.event = batch, event

    def ready(self) -> Any:
        stream = torch.cuda.current_stream(self.event.device)
        stream.wait_event(self.event)
        for t in _tensors(self.batch):
            t.record_stream(stream)
        return self.batch


def device_put(device: DeviceLike,
               finish: Optional[Callable] = None) -> Callable:
    """The ``put_fn`` that moves a batch (tensors in dicts, lists and
    tuples) to ``device`` and runs ``finish`` on it where given (module
    docstring)."""
    device = torch.device(device)
    if device.type != "cuda":
        def put_host(batch):
            moved = _move(batch, device, [])
            return finish(moved) if finish is not None else moved
        return put_host
    side: List[torch.cuda.Stream] = []

    def put(batch):
        if not side:  # made on the worker thread that uses it
            side.append(torch.cuda.Stream(device))
        copies: List[torch.Tensor] = []
        with torch.cuda.stream(side[0]):
            out = _move(batch, device, copies)
            if finish is not None:
                out = finish(out)
            elif not copies:
                return out
            event = torch.cuda.Event()
            event.record(side[0])
        return _Staged(out, event)

    return put


def _tensors(tree) -> List[torch.Tensor]:
    """The CUDA tensors of a batch."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_cuda else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _move(tree, device: torch.device, copies: List[torch.Tensor]):
    if isinstance(tree, torch.Tensor):
        if tree.device == device or device.type == "cpu":
            return tree
        out = tree.pin_memory().to(device, non_blocking=True)
        copies.append(out)
        return out
    if isinstance(tree, dict):
        return {k: _move(v, device, copies) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_move(v, device, copies) for v in tree)
    return tree


class DevicePrefetcher:
    """Iterates ``batches`` ``depth`` ahead on a worker thread, in order;
    ``put_fn`` (if given) runs on the worker on each batch. An exception of
    the worker is raised in the consumer, after the batches made before
    it."""

    _SENTINEL = object()

    def __init__(self, batches: Iterator, put_fn: Optional[Callable] = None,
                 depth: int = 4):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._done = False

        def worker():
            try:
                for batch in batches:
                    self._queue.put(put_fn(batch) if put_fn else batch)
            except BaseException as e:  # raised in the consumer
                self._error = e
            finally:
                self._queue.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is self._SENTINEL:
            self._done = True
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item.ready() if isinstance(item, _Staged) else item
