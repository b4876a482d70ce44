"""How far implementations of the spatial stack's forward agree at narrow
widths, on the card: the kernel of this checkout and, given one, a parent's
(PARENT_CSRC, e.g. from ``git archive <commit>
pedestrians_video_2_carla_torch/csrc | tar -x -C build/parent``), and the
plain version in float32, each against the plain version in float64, as
max |error| over max |float64|; and the kernel against the float32 plain
version (the measure of chip_smoke.py's kernel bar). Seeded weights as
chip_smoke.py's, N=67 frames, depth 4, at shapes (J, E, heads, hidden) of
E=4 (the LayerNorm over 4 values), E=12 and E=32; the parent's kernel at
this checkout's frames a thread block (kernel_tiles), which the earlier
CUDA-core design took at these shapes too.

    python3 tools/spatial_edge_precision.py OUT.json [PARENT_CSRC]

Needs one CUDA card.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from pedestrians_video_2_carla_torch.ops import \
    fused_spatial_transformer as FS  # noqa: E402

SHAPES = ((32, 4, 1, 1172), (26, 4, 1, 1172), (32, 4, 1, 1024),
          (32, 4, 1, 64), (26, 4, 1, 8), (32, 12, 3, 864), (26, 32, 8, 64))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out_path = sys.argv[1]
    parent = cs.spatial_library(Path(sys.argv[2]) / FS._SOURCE.name) \
        if len(sys.argv) > 2 else None
    card, _ = cs.phase_device()
    rng = np.random.default_rng(cs.SEED + 3)

    def err(a, ref):
        return float((a.double() - ref).abs().max() / ref.abs().max())
    rows = []
    for J, E, H, hidden in SHAPES:
        ws = cs.random_spatial_weights(rng, E, hidden)
        x = torch.from_numpy(rng.standard_normal((67, J, E)).astype(
            np.float32)).cuda()
        out = FS.fused_spatial_stack_cuda(x, ws, H)
        plain = FS.spatial_stack_reference(x, ws, H)
        ref = FS.spatial_stack_reference(x.double(),
                                         [w.double() for w in ws], H)
        row = {"J": J, "E": E, "heads": H, "hidden": hidden,
               "kernel_vs_plain": cs.bar_err(out, plain)[1],
               "kernel_vs_f64": err(out, ref), "plain_vs_f64": err(plain, ref)}
        if parent is not None:
            old = cs.spatial_launch(parent, x, ws, H,
                                    FS.kernel_tiles(J, E, H, hidden)[0], False)
            row.update(parent_vs_plain=cs.bar_err(old, plain)[1],
                       parent_vs_f64=err(old, ref))
        rows.append(row)
        print(json.dumps(row), flush=True)
    with open(out_path, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
