"""Tracing and timing: wall-time accumulators per function or region
(``timing``, ``timed``, ``print_timing``) and a ``torch.profiler`` device
trace of a code region (``device_trace``), written as a Chrome / Perfetto
trace JSON, with named regions in it (``annotate``)."""
import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict

import torch

_TIMINGS: Dict[str, list] = defaultdict(lambda: [0.0, 0])


def timing(fn):
    """Accumulate the wall time of each call of ``fn``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            entry = _TIMINGS[f"{fn.__module__}.{fn.__qualname__}"]
            entry[0] += time.perf_counter() - t0
            entry[1] += 1
    return wrapper


@contextlib.contextmanager
def timed(name: str):
    """Accumulate the wall time of a region under ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        entry = _TIMINGS[name]
        entry[0] += time.perf_counter() - t0
        entry[1] += 1


def get_timings() -> Dict[str, Dict[str, float]]:
    return {k: {"total_s": v[0], "calls": v[1],
                "mean_ms": v[0] / max(v[1], 1) * 1e3}
            for k, v in _TIMINGS.items()}


def print_timing() -> None:
    for name, t in sorted(get_timings().items()):
        print(f"{name}: {t['total_s']:.3f}s over {t['calls']} calls "
              f"({t['mean_ms']:.2f} ms/call)")


def reset_timings() -> None:
    _TIMINGS.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """A ``torch.profiler`` trace of the region: CPU and CUDA activity
    where ``device`` is the card (the default when one is there), CPU
    only otherwise. On exit the trace goes to
    ``{log_dir}/trace.json``, a Chrome trace that Perfetto and
    ``chrome://tracing`` open; the CUDA kernels are its events of
    category ``kernel``."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available() if device is None \
        else torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if on_card:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region that shows in device traces."""
    return torch.profiler.record_function(name)
