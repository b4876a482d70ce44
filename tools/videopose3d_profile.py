"""Where BASELINE config 4's device time goes: a torch.profiler trace (with
input shapes) of 3 requests and 3 training steps of VideoPose3D (filter
widths (3, 3, 3, 3), 1024 channels, B=64, L=81; chip_smoke.py's
group_lifters shapes) after 2 warm-up calls each: the device time a call
and its launches, by device kernel and by the CPU operation (name and
input shapes) that launched it, the top 15 of each.

    python3 tools/videopose3d_profile.py OUT.json

Needs one CUDA card (about 30 s held).
"""
import json
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
    Carla2D3DDataModule  # noqa: E402
from pedestrians_video_2_carla_torch.serving import \
    make_inference_fn  # noqa: E402

CALLS, TOP = 3, 15


def device_split(fn):
    """Device time and launches over CALLS calls of ``fn``: by device
    kernel, and by the CPU operation (with its input shapes) that launched
    them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    kernels, ops = {}, {}
    for avg in prof.key_averages(group_by_input_shape=True):
        device_us = getattr(avg, "self_device_time_total", None)
        if device_us is None:
            device_us = avg.self_cuda_time_total
        if device_us <= 0:
            continue
        on_device = avg.device_type.name == "CUDA"
        rows = kernels if on_device else ops
        key = avg.key if on_device else f"{avg.key} {avg.input_shapes}"
        ms, n = rows.get(key, (0.0, 0.0))
        rows[key] = (ms + device_us / 1e3 / CALLS, n + avg.count / CALLS)

    def top(rows):
        return [[k[:200], ms, n] for k, (ms, n) in
                sorted(rows.items(), key=lambda kv: -kv[1][0])[:TOP]]
    return {"device_ms_per_call": sum(ms for ms, _ in kernels.values()),
            "kernels_per_call": sum(n for _, n in kernels.values()),
            "top_kernels_ms_and_launches_per_call": top(kernels),
            "top_ops_ms_and_calls_per_call": top(ops)}


def main():
    out_path = sys.argv[1]
    card, _ = cs.phase_device()
    dm = Carla2D3DDataModule(batch_size=cs.VP_BATCH, clip_length=cs.VP_CLIP,
                             seed=cs.SEED)
    flow = cs.make_vp_flow()
    params = cs.vp_params(flow)
    state = flow.init_state(params)
    batch = next(dm.train_batches(cs.SEED + 9))
    inputs, _, meta = next(dm.test_batches())
    infer = make_inference_fn(flow, params)
    result = {
        "card": card, "B": cs.VP_BATCH, "L": cs.VP_CLIP,
        "request": device_split(lambda: infer(inputs,
                                              meta["age_gender_idx"])),
        "train_step": device_split(lambda: flow.training_step(state, batch)),
        "method": "torch.profiler (CPU and CUDA, record_shapes) over %d "
                  "calls after 2 warm-ups; key_averages grouped by input "
                  "shape, self device time per call" % CALLS}
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result)[:20000])


if __name__ == "__main__":
    main()
