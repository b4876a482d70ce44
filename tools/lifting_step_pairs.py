"""LinearAE's training step (``fused_train``, B=1024, L=16: chip_smoke.py's
timing_train shape) on this tree's projection training kernels and on a
parent's, in one process on one card: the parent's
``fused_projection_train.cu`` (whose C interface this tree's wrapper
calls) is built beside this one's, and each turn loads one of the two
libraries for the wrapper and times the host-clock median of 30 steps
after 3 warm-up steps (``chip_smoke.host_median_ms``), in 10 pairs of
alternating order. Only the kernels differ between the two sides.

    git archive <commit> pedestrians_video_2_carla_torch/csrc | tar -x -C build/parent
    python3 tools/lifting_step_pairs.py build/parent/pedestrians_video_2_carla_torch/csrc OUT.json

Needs one CUDA card.
"""
import json
import os
import shutil
import statistics
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
    Carla2D3DDataModule  # noqa: E402
from pedestrians_video_2_carla_torch.ops import cuda_build  # noqa: E402
from pedestrians_video_2_carla_torch.ops import \
    fused_projection as FP  # noqa: E402

PAIRS = 10


def main():
    parent, out_path = Path(sys.argv[1]), sys.argv[2]
    card, _ = cs.phase_device()
    d = cuda_build.BUILD_DIR.parent / "parent_projection"
    d.mkdir(parents=True, exist_ok=True)
    source = d / FP._TRAIN_SOURCE.name
    shutil.copy(parent / FP._TRAIN_SOURCE.name, source)
    for header in cuda_build._local_headers(source):
        shutil.copy(parent / header.name, d / header.name)
    libs = {"this": FP._library("train"),
            "parent": cuda_build.load_library(source,
                                              FP._SIGNATURES["train"])}
    dm = Carla2D3DDataModule(batch_size=cs.BATCH, clip_length=cs.CLIP,
                             val_set_size=cs.VAL_BATCHES * cs.BATCH,
                             seed=cs.SEED)
    flow = cs.make_train_flow("fused_train")
    batch = next(dm.train_batches(cs.SEED + 7))
    state = flow.init_state(flow.init_params())
    times = {"this": [], "parent": []}
    for i in range(PAIRS):
        for name in ("parent", "this") if i % 2 == 0 else ("this", "parent"):
            cuda_build._loaded[FP._TRAIN_SOURCE] = libs[name]
            times[name].append(cs.host_median_ms(
                lambda: flow.training_step(state, batch)))
    cuda_build._loaded[FP._TRAIN_SOURCE] = libs["this"]
    out = {"card": card, "step_ms": times,
           "median": {k: statistics.median(v) for k, v in times.items()},
           "this_faster_in": sum(a < b for a, b in zip(times["this"],
                                                       times["parent"]))}
    print(json.dumps(out), flush=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
