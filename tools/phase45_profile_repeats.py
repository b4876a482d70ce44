"""Repeat the profiled windows of ``chip_smoke.py``'s phase 45
(``phase_epoch_config3``: GConvGRU resident on config 3's subsets, the
graphed and the eager resident epochs) and record, for every window, the
launches each wrapper counted against the kernels the profiler shows,
read two ways: torch's parsed events (``prof.events()``, what the phase
reads) and kineto's raw activity records (``prof.profiler.kineto_results``).
A window where the two disagree, or where either misses a counted
launch, gets its scan kernels' records written out (name, start, end,
correlation id), and all its device records and the window's before it.
Each route is repeated in three modes: ``bare`` (the profiled call after
an unprofiled one), ``warmup`` (the profiler's warm-up step,
``schedule(warmup=1, active=1)``) and ``guarded`` (``chip_smoke.py``'s
``profiled_launches``: a guard call in the trace before the measured
one; its windows record the guard's device records, where a lost block
shows).

Run on the card (it builds the kernels first):

    python3 tools/phase45_profile_repeats.py OUT.json [REPEATS] [MODES]
"""
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def _device_records(prof):
    """(torch's parsed device events, kineto's raw device records): each a
    list of (name, start_us, end_us, correlation id or None)."""
    parsed = [(e.name, e.time_range.start, e.time_range.end,
               getattr(e, "id", None)) for e in prof.events()
              if getattr(e, "device_type", None) is not None
              and e.device_type.name == "CUDA"]
    raw = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        start = e.start_ns() / 1e3 if hasattr(e, "start_ns") \
            else e.start_us()
        end = start + (e.duration_ns() / 1e3 if hasattr(e, "duration_ns")
                       else e.duration_us())
        corr = e.correlation_id() if hasattr(e, "correlation_id") else None
        raw.append((e.name(), start, end, corr))
    return parsed, raw


def window(fn, rows, warmup):
    """One profiled call of ``fn``, and another to count. Without
    ``warmup`` the profiled call follows an unprofiled one; with it, the
    unprofiled call is the profiler's warm-up step (its schedule's
    ``warmup=1``: activity collection already on, its records dropped),
    and the active step the profiled call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    t0 = time.perf_counter()
    if warmup:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
    else:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    parsed, raw = _device_records(prof)
    before = cs.kernel_counts()
    fn()
    torch.cuda.synchronize()
    after = cs.kernel_counts()
    out = {"window_s": window_s, "device_parsed": len(parsed),
           "device_raw": len(raw), "rows": {}}
    bad = False
    for w, parts in rows.items():
        counted = after[w] - before[w]
        p = [r for r in parsed if any(x in r[0] for x in parts)]
        r = [r for r in raw if any(x in r[0] for x in parts)]
        out["rows"][w] = {"counted": counted, "parsed": len(p),
                          "raw": len(r)}
        if not counted == len(p) == len(r):
            bad = True
            out["rows"][w].update(parsed_events=p, raw_events=r)
    out["raw_records"] = [(r[0][:60], r[1], r[2], r[3]) for r in raw]
    return out, bad


def guarded(fn, rows):
    """``chip_smoke.profiled_launches`` itself (a guard call, then the
    measured one): its rows, and the guard's count of device records,
    where a lost leading block shows."""
    trace, launches = cs.profiled_launches(fn, rows)
    out = {"guard_device_events": trace["guard_device_events"],
           "device_events": trace["device_events"],
           "rows": {w: {"counted": r["counted"], "parsed": r["profiler"],
                        "raw": r["profiler"]} for w, r in launches.items()}}
    return out, any(r["counted"] != r["profiler"]
                    for r in launches.values())


def main():
    path = sys.argv[1]
    repeats = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    modes = sys.argv[3].split(",") if len(sys.argv) > 3 \
        else ("bare", "warmup", "guarded")
    card, _ = cs.phase_device()
    cs.phase_build()
    rows = {"graph_gru_scan": cs.ROW10_KERNELS,
            "graph_gru_scan_bwd": cs.ROW11_SCAN_KERNELS}
    resident, _ = cs.openpose_datamodule(device_resident=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "repeats": repeats,
              "steps_a_window": cs.REC_PROFILE_STEPS, "routes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        trainers = {}
        for route in ("resident_eager", "resident_graphed"):
            trainers[route] = cs.fit_route(route, resident, tmp,
                                           validate=False,
                                           make_flow=cs.make_cls_flow)[0]
        for mode in modes:
            for route, t in trainers.items():
                windows, misses = [], 0
                for _ in range(repeats):
                    fn = (lambda t=t: t.runner(t.state, 0,
                                               cs.REC_PROFILE_STEPS))
                    if mode == "guarded":
                        w, bad = guarded(fn, rows)
                    else:
                        w, bad = window(fn, rows, mode == "warmup")
                    misses += bad
                    windows.append(w)
                # the full records of the missing windows and of the window
                # before each, the rest's counts alone
                keep = {i for i, w in enumerate(windows)
                        if any(not r["counted"] == r["parsed"] == r["raw"]
                               for r in w["rows"].values())}
                keep |= {i - 1 for i in keep if i}
                for i, w in enumerate(windows):
                    if i not in keep:
                        w.pop("raw_records", None)
                name = f"{route}_{mode}"
                records = [w.get("device_raw", w.get("guard_device_events"))
                           for w in windows]
                report["routes"][name] = {"misses": misses,
                                          "windows": windows,
                                          "device_records": records}
                cs.emit({"phase": "phase45_repeats", "route": name,
                         "misses": misses, "repeats": repeats,
                         "device_records": sorted(set(records))})
    with open(path, "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
