"""Per-call host times of config 1's serving artifacts and closures on the
card: LinearAE on "fused" (all outputs, and ``projection_2d`` alone) and
on "fused_train" at B=1024, L=16, each exported (``serving.
export_inference``) and loaded (``load_inference``) in this process, then
40 alternating pairs of single requests (artifact, closure, closure,
artifact, ...). Each call's wall and process CPU milliseconds and the
garbage collections that ran inside it (how many, how many full, their
milliseconds) show whether a slow call did work of its own or collected
the process's objects.

    python3 tools/serving_calls.py OUT.json

One JSON line a case (also written to OUT.json): the program's node count,
the live objects, and the calls as ``[which, wall_ms, cpu_ms,
collections, full, gc_ms]``. Needs one CUDA card.
"""
import gc
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from pedestrians_video_2_carla_torch import serving as S  # noqa: E402
from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
    Carla2D3DDataModule  # noqa: E402

PAIRS = 40


def main(out_path):
    cs.phase_device()
    out = []
    with tempfile.TemporaryDirectory() as tmp, cs.GcWatch() as watch:
        for name, flow, B, keys, _ in cs.artifact_cases()[:3]:
            inputs, _, meta = next(iter(Carla2D3DDataModule(
                batch_size=B, clip_length=cs.CLIP, seed=cs.SEED,
                test_set_size=B).test_batches()))
            agi = meta["age_gender_idx"]
            params = flow.init_params()
            infer = S.make_inference_fn(flow, params, output_keys=keys)
            path = S.export_inference(flow, params, inputs, agi,
                                      os.path.join(tmp, f"{name}.pt2"),
                                      output_keys=keys)
            call, _ = S.load_inference(path)
            fns = (("artifact", lambda: call(inputs, agi)),
                   ("closure", lambda: infer(inputs, agi)))
            rows = []
            for i in range(PAIRS):
                for which, fn in fns[::1 if i % 2 == 0 else -1]:
                    before = watch.stats()
                    torch.cuda.synchronize()
                    wall, cpu = time.perf_counter(), time.process_time()
                    fn()
                    torch.cuda.synchronize()
                    after = watch.stats()
                    rows.append([which,
                                 (time.perf_counter() - wall) * 1e3,
                                 (time.process_time() - cpu) * 1e3,
                                 after["collections"] - before["collections"],
                                 after["full"] - before["full"],
                                 after["ms"] - before["ms"]])
            line = {"case": name, "B": B, "L": cs.CLIP,
                    "nodes": len(torch.export.load(path).graph.nodes),
                    "objects": len(gc.get_objects()), "calls": rows}
            print(json.dumps(line), flush=True)
            out.append(line)
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
