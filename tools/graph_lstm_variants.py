"""Times variants of the graph-form LSTM scan kernels on the card against
the source as it is: each variant is a copy of csrc/fused_graph_gru.cu
(with the headers it includes) under build/lstm_variants/<name>/ with one
text substitution, built in parallel, its forward (keep) checked against
the plain version and its training forward and backward timed (CUDA
events, cold L2, medians) at GConvLSTM's layer (B=256, L=16, J=26, H=128,
k=2) and at k = 1 past the dense width (B=256, L=16, J=1, H=128), in two
rounds of opposite order.

    python3 tools/graph_lstm_variants.py OUT.json

Variants: ``rows16`` the few-rows tiling filled to 16 rows a thread block
(16 thread blocks at J=1) instead of the clips that cover the SMs;
``stages3`` a 3-stage weight ring; ``bwd_ring64`` the reverse scan's ring
64 columns wide where 128 fits. Needs one CUDA card.
"""
import json
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from pedestrians_video_2_carla_torch.ops import cuda_build  # noqa: E402
from pedestrians_video_2_carla_torch.ops import \
    fused_graph_gru as FG  # noqa: E402

VARIANTS = {
    "base": None,
    "rows16": ("for (int C = want; C >= 1; --C)",
               "for (int C = few ? std::min(kFewRowsMax / J, B) : want; "
               "C >= 1; --C)"),
    "stages3": ("constexpr int kGStages = 2;", "constexpr int kGStages = 3;"),
    "bwd_ring64": ("return bwd ? (v == 0   ? LstmTiling{128, 8, 2}",
                   "return bwd ? (v == 0   ? LstmTiling{64, 8, 2}"),
}
SHAPES = (cs.CLS_MAIN, (256, 16, 1, 128, 1))


def variant_sources():
    text = FG._SOURCE.read_text()
    sources = {}
    for name, sub in VARIANTS.items():
        if sub is None:
            sources[name] = FG._SOURCE
            continue
        if sub[0] not in text:
            raise ValueError(f"variant {name}: {sub[0]!r} not in the source")
        d = cuda_build.BUILD_DIR.parent / "lstm_variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / FG._SOURCE.name).write_text(text.replace(*sub))
        for header in cuda_build._local_headers(FG._SOURCE):
            shutil.copy(header, d / header.name)
        sources[name] = d / FG._SOURCE.name
    return sources


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card, _ = cs.phase_device()
    sources = variant_sources()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_build.build_library, sources.values()))
    libs = {n: cuda_build.load_library(p, FG._SIGNATURES)
            for n, p in sources.items()}
    rng = np.random.default_rng(cs.SEED + 17)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    out = {"card": card}
    for shape in SHAPES:
        B, _, J, H, k = shape
        xg, cheb, (w,), cots = cs.graph_case(rng, "lstm", shape)
        ref = FG.graph_lstm_scan_keep_reference(xg, cheb, w)
        rows = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                FG._library = lambda lib=libs[name]: lib
                FG._scan_plan.cache_clear()  # the variant's own plans
                _, c_s, res = FG.graph_lstm_scan_cuda_fwd(xg, cheb, w,
                                                          keep=True)
                err = max(float((a - b).abs().max())
                          for a, b in zip(res, ref[2]))
                if err > cs.SCAN_BAR:
                    raise AssertionError(f"variant {name} at {shape}: {err}")
                t = {"keep_ms": cs.cuda_median_ms(
                         lambda: FG.graph_lstm_scan_cuda_fwd(xg, cheb, w,
                                                             keep=True),
                         flush=flush),
                     "bwd_ms": cs.cuda_median_ms(
                         lambda: FG.graph_lstm_scan_cuda_bwd(cheb, w, res,
                                                             c_s, *cots),
                         flush=flush),
                     "plan_fwd": FG.graph_lstm_plan(B, J, H, k),
                     "plan_bwd": FG.graph_lstm_plan(B, J, H, k, True)}
                rows.setdefault(name, []).append(t)
                print(json.dumps({"B_L_J_H_k": shape, "variant": name, **t}),
                      flush=True)
        out[str(shape)] = rows
    with open(sys.argv[1], "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
