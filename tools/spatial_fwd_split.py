"""Where the spatial stack's forward kernel spends its time, on the card, by
phase, for any source of csrc/fused_spatial_transformer.cu: this
checkout's, or an earlier design's taken from a parent commit. The source
is built as it is, and timed (CUDA events, cold L2, median of 30, twice);
then an instrumented copy of it (chip_smoke.instrument_spatial_forward: a
clock64() stamp by lane 0 of each warp at the forward kernel's start, after
every barrier of the forward and at its end), built under
build/spatial_split/, runs once with the stamps on. Each phase's share of
the summed cycles of the warps of live frames, times the kernel's time,
gives its milliseconds. Serving and training (``keep``), at PoseFormer's
serving shape (B=256, L=16: N=4096 frames of J=26 tokens, E=32, 8 heads,
hidden 64, depth 4). chip_smoke.py's timing_poseformer phase runs the same
split on this checkout's source, serving only.

    git archive 22233d3 pedestrians_video_2_carla_torch/csrc | tar -x -C build/parent
    python3 tools/spatial_fwd_split.py build/parent/pedestrians_video_2_carla_torch/csrc/fused_spatial_transformer.cu OUT.json

FRAMES, an optional third argument, is the frames a thread block (by
default this checkout's kernel_tiles; the earlier CUDA-core design took 4
at this shape too). Needs one CUDA card.
"""
import json
import os
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from pedestrians_video_2_carla_torch.ops import \
    fused_spatial_transformer as FS  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    source, out_path = Path(sys.argv[1]), sys.argv[2]
    frames = int(sys.argv[3]) if len(sys.argv) > 3 else FS.kernel_tiles(
        cs.PF_JOINTS, cs.PF_EMB, cs.PF_HEADS, 2 * cs.PF_EMB)[0]
    card, _ = cs.phase_device()
    lib = cs.spatial_library(source)
    copy, design = cs.spatial_split_source(source)

    rng = np.random.default_rng(cs.SEED + 3)
    ws = cs.random_spatial_weights(rng)
    n = cs.SPATIAL_NS[0]
    x = torch.from_numpy(rng.standard_normal(
        (n, cs.PF_JOINTS, cs.PF_EMB)).astype(np.float32)).cuda()
    got = cs.spatial_launch(lib, x, ws, cs.PF_HEADS, frames, False)
    _, scaled = cs.bar_err(got, FS.spatial_stack_reference(x, ws,
                                                           cs.PF_HEADS))
    if scaled > cs.KERNEL_BAR:
        raise AssertionError(f"{source}: {scaled} of max |plain|")
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = {"card": card, "source": str(source), "N": n,
           "frames_a_thread_block": frames, "max_err_over_max_plain": scaled}
    for name, keep in (("serve", False), ("keep", True)):
        times = [cs.cuda_median_ms(
            lambda: cs.spatial_launch(lib, x, ws, cs.PF_HEADS, frames, keep),
            flush=scratch.zero_) for _ in range(2)]
        split, stamped = cs.spatial_phase_split(
            copy, design, x, ws, cs.PF_HEADS, frames, keep,
            statistics.median(times))
        if not torch.equal(stamped, cs.spatial_launch(
                lib, x, ws, cs.PF_HEADS, frames, keep)):
            raise AssertionError("the instrumented copy computes other bits")
        out[name] = {"ms": times, "split": split}
        print(json.dumps({name: out[name]}), flush=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
