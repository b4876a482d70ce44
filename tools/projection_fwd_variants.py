"""Times the projection's two forward kernels, rows 1 and 2
(csrc/fk_forward.cuh through csrc/fused_projection.cu and
csrc/fused_projection_train.cu), against a parent's and against variants
of their chunk plan, on one card.

    git archive <commit> pedestrians_video_2_carla_torch/csrc | tar -x -C build/parent
    python3 tools/projection_fwd_variants.py OUT.json [PARENT_CSRC]

PARENT_CSRC: a parent's pedestrians_video_2_carla_torch/csrc, whose two
sources (the same C interfaces) are built beside this tree's. Each variant
is a copy of both sources with lines of fk_forward.cuh substituted
(VARIANTS: its plan constants, or the FK of the design's first version),
under build/fwd_variants/<name>/. Everything builds in
parallel. At B=1024 and L in {1, 16, 81}, every library is first held to
the plain version (1e-3 px on x and y, 1e-4 on depth, and for row 2 1e-5
on abs_loc against the algorithm's; the states' error is printed), then
timed: this tree against the parent in
10 alternating pairs (chip_smoke.paired_ms: medians of each and of their
ratio), and every library alone (CUDA events, cold L2, medians of 30, two
rounds in opposite order). Needs one CUDA card; prints one JSON line per
measurement and writes OUT.json.
"""
import ctypes
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
from pedestrians_video_2_carla_torch.ops import camera as C  # noqa: E402
from pedestrians_video_2_carla_torch.ops import cuda_build  # noqa: E402
from pedestrians_video_2_carla_torch.ops import \
    fused_projection as FP  # noqa: E402

HEADER = "fk_forward.cuh"
UNITS = "constexpr int kUnits = 32; "
LONG = "constexpr int kLongFrames = 16; "
CLIPS = "constexpr int kMaxClips = 8; "
PROJECTION = "    // ---- the projection, every (unit, bone) at once ----\n"
THREADS = "constexpr int kThreads = 256; "
#: the FK of the first version of this design, kept as a variant: a thread
#: a (unit, bone) walks its own ancestor path from the root, the ancestors'
#: S and loc read one step ahead, no barrier between tree levels (111
#: location steps and 86 compositions a frame on CARLA's tree where the
#: levels take 25 of each). The paths are built from the parents in the
#: prologue; the walk takes the place of the level loop (the region from
#: WALK_START to WALK_END).
PATHS_AT = "  float carry[9];  // the carry of a (clip, bone) from chunk to chunk\n"
PATHS = """  __shared__ unsigned char v_path[kMaxBones * kMaxBones];
  __shared__ int v_depth[kMaxBones], v_parent[kMaxBones];
  for (int k = threadIdx.x; k < J; k += blockDim.x)
    v_parent[tree.entry[k] & 255] = (tree.entry[k] >> 8) - 1;
  __syncthreads();
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    int d = 0;
    for (int a = v_parent[j]; a >= 0; a = v_parent[a]) ++d;
    v_depth[j] = d;
    for (int k = d, a = j; k >= 0; --k, a = v_parent[a])
      v_path[k * kMaxBones + j] = static_cast<unsigned char>(a);
  }
"""
WALK_START = "    // ---- the FK, level by level"
WALK_END = "    FK_STAMP(2)\n"
WALK = """    if (TRAIN) store_range(states, buf, row0 * 9, units * J * 9);
    const Camera c = cm;
    float* P = smem + lay.proj;
    float* A = smem + lay.abs;
    const int po = static_cast<int>((row0 * 3) & 3);
    for (int i = threadIdx.x; i < units * J; i += blockDim.x) {
      const int u = i / J, b = i - u * J;
      const float* S = Cm + u * J * 9;
      const float* lc = LOC + (u / F) * J * 3;
      const int d = v_depth[b];
      int a = v_path[b];
      float ar[9], al[3], sn[9], ln[3];
#pragma unroll
      for (int e = 0; e < 9; ++e) ar[e] = S[a * 9 + e];
#pragma unroll
      for (int e = 0; e < 3; ++e) al[e] = lc[a * 3 + e];
      if (d > 0) {
        a = v_path[kMaxBones + b];
#pragma unroll
        for (int e = 0; e < 3; ++e) ln[e] = lc[a * 3 + e];
        if (d > 1) {
#pragma unroll
          for (int e = 0; e < 9; ++e) sn[e] = S[a * 9 + e];
        }
      }
      for (int s = 1; s <= d; ++s) {
        float l[3], sa[9];
#pragma unroll
        for (int e = 0; e < 3; ++e) l[e] = ln[e];
#pragma unroll
        for (int e = 0; e < 9; ++e) sa[e] = sn[e];
        if (s < d) {
          a = v_path[(s + 1) * kMaxBones + b];
#pragma unroll
          for (int e = 0; e < 3; ++e) ln[e] = lc[a * 3 + e];
          if (s + 1 < d) {
#pragma unroll
            for (int e = 0; e < 9; ++e) sn[e] = S[a * 9 + e];
          }
        }
#pragma unroll
        for (int j = 0; j < 3; ++j)
          al[j] = l[0] * ar[j] + l[1] * ar[3 + j] + l[2] * ar[6 + j] + al[j];
        if (s < d) {
          float nr[9];
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int j = 0; j < 3; ++j)
              nr[r * 3 + j] = sa[r * 3 + 0] * ar[0 + j]
                            + sa[r * 3 + 1] * ar[3 + j]
                            + sa[r * 3 + 2] * ar[6 + j];
#pragma unroll
          for (int e = 0; e < 9; ++e) ar[e] = nr[e];
        }
      }
      const float wx = al[1], wy = -al[0], wz = al[2];
      const float vx = wx * c.r[0] + wy * c.r[3] + wz * c.r[6] + c.t[0];
      const float vy = wx * c.r[1] + wy * c.r[4] + wz * c.r[7] + c.t[1];
      const float vz = wx * c.r[2] + wy * c.r[5] + wz * c.r[8] + c.t[2];
      const float inv_z = 1.0f / vz;
      float* o = P + po + i * 3;
      o[0] = c.w - (c.fx * vx * inv_z + c.px);
      o[1] = c.h - (c.fy * vy * inv_z + c.py);
      o[2] = vz;
#pragma unroll
      for (int e = 0; e < 3; ++e) A[po + i * 3 + e] = al[e];
    }
    __syncthreads();
    FK_STAMP(2)
"""
#: substitutions of fk_forward.cuh's lines: the (clip, frame) units a
#: chunk, the clips a thread block at most, the threads a thread block
VARIANTS = {
    "long8": ((LONG, "constexpr int kLongFrames = 8; "),),
    "long32": ((LONG, "constexpr int kLongFrames = 32; "),),
    "units16": ((UNITS, "constexpr int kUnits = 16; "),),
    "units64": ((UNITS, "constexpr int kUnits = 64; "),),
    "clips4": ((CLIPS, "constexpr int kMaxClips = 4; "),),
    "clips16": ((CLIPS, "constexpr int kMaxClips = 16; "),
                (THREADS, "constexpr int kThreads = 512; ")),
    "threads128": ((THREADS, "constexpr int kThreads = 128; "),),
    "threads512": ((THREADS, "constexpr int kThreads = 512; "),),
    # the FK's two quotients by integer division (the source: quot())
    "int_division": (("quot(i, inv), e", "i / nb, e"),
                     ("(quot(u, inv_F) * J", "((u / F) * J")),
    "ancestor_walk": ((PATHS_AT, PATHS + PATHS_AT),
                      ((WALK_START, WALK_END), WALK)),
    # what each phase costs, by its removal (the outputs are then wrong,
    # so these are timed unchecked)
    "diag_nocarry": ((("    // ---- the carry:", "    FK_STAMP(1)\n"),
                      "    FK_STAMP(1)\n"),),
    "diag_nofk": ((("    for (int d = 0; d < tr.num_levels; ++d) {",
                    PROJECTION),
                   """    for (int i = threadIdx.x; i < units * J; i += blockDim.x)
      for (int m = 0; m < 3; ++m)
        A[po + i * 3 + m] = LOC[((i / J) / F * J + i % J) * 3 + m];
    __syncthreads();
""" + PROJECTION),),
    "diag_noprojection": (((PROJECTION, WALK_END),
                           "    __syncthreads();\n" + WALK_END),),
    "diag_nocopy": (("    store_range(proj, P, row0 * 3, units * J * 3);\n",
                     ""),),
}
CLIPS_TIMED = cs.FWD_TIMED_CLIPS
PAIRS = 10


def copy_sources(csrc, name, subs):
    """Both forward sources of ``csrc`` with their headers under
    build/fwd_variants/``name``/, the header's lines substituted."""
    d = cuda_build.BUILD_DIR.parent / "fwd_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    for source in (FP._SOURCE.name, FP._TRAIN_SOURCE.name):
        shutil.copy(csrc / source, d / source)
        for header in cuda_build._local_headers(csrc / source):
            shutil.copy(header, d / header.name)
    if subs:
        text = (d / HEADER).read_text()
        for old, new in subs:
            # a string, or a region (from its first line to its last)
            start, end = old if isinstance(old, tuple) else (old, "")
            if text.count(start) != 1 or (end and text.count(end) != 1):
                raise ValueError(f"variant {name}: {old!r} is not one place "
                                 f"of {HEADER}")
            a = text.index(start)
            b = text.index(end, a) + len(end) if end else a + len(start)
            text = text[:a] + new + text[b:]
        (d / HEADER).write_text(text)
    return d


def load(path, which):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in FP._SIGNATURES[which].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out_path = sys.argv[1]
    parent = Path(sys.argv[2]) if len(sys.argv) > 2 else None
    card, _ = cs.phase_device()
    dirs = {"this": copy_sources(cuda_build.CSRC, "this", ())}
    for name, subs in VARIANTS.items():
        dirs[name] = copy_sources(cuda_build.CSRC, name, subs)
    if parent is not None:
        dirs["parent"] = copy_sources(parent, "parent", ())
    jobs = [(name, which, d / src.name) for name, d in dirs.items()
            for which, src in (("serve", FP._SOURCE),
                               ("train", FP._TRAIN_SOURCE))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda j: cuda_build.build_library(j[2]), jobs))
    libs = {}
    for (name, which, _), path in zip(jobs, paths):
        libs.setdefault(name, {})[which] = load(path, which)
        log = path.with_suffix(".log").read_text()
        print(json.dumps({"built": name, "which": which, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)

    cam = C.make_camera()
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(cs.SEED + 8)
    result = {"card": card, "pairs": {}, "alone": {}, "errors": {}}
    for L in CLIPS_TIMED:
        B = cs.BATCH
        args = cs.kernel_inputs(rng, B, L, "cuda")
        ref_p, ref_a, ref_s = FP.fused_projection_fwd_algorithm(
            *args, cam, train=True)
        plain = FP.fused_projection_reference(*args, cam)

        def serve(lib):
            out = torch.empty_like(plain)
            FP._launch(lib.pv2c_fused_projection, args[0].device, *args,
                       out, B, L, cam)
            return out

        def train(lib):
            outs = (torch.empty_like(ref_p), torch.empty_like(ref_a),
                    torch.empty_like(ref_s))
            FP._launch(lib.pv2c_fused_projection_train_fwd, args[0].device,
                       *args, *outs, B, L, cam)
            return outs
        runs = {}
        for name, pair in libs.items():
            p = serve(pair["serve"])
            q, a, s = train(pair["train"])
            torch.cuda.synchronize()
            errs = {"xy_px": max(cs.proj_errs(p, plain)[0],
                                 cs.proj_errs(q, plain)[0]),
                    "depth": max(cs.proj_errs(p, plain)[1],
                                 cs.proj_errs(q, plain)[1]),
                    "abs_loc": float((a - ref_a).abs().max()),
                    "states": float((s - ref_s).abs().max())}
            result["errors"].setdefault(name, {})[f"L{L}"] = errs
            if not name.startswith("diag_") and not (
                    errs["xy_px"] <= cs.XY_TOL_PX
                    and errs["depth"] <= cs.DEPTH_TOL
                    and errs["abs_loc"] <= cs.ABS_TOL):
                print(json.dumps({"disagrees": name, "L": L, **errs}),
                      flush=True)
                continue
            runs[name] = pair
        for which, fn in (("serve", serve), ("train", train)):
            key = f"{which}_L{L}"
            if parent is not None and "parent" in runs:
                result["pairs"][key] = cs.paired_ms(
                    lambda: fn(runs["this"][which]),
                    lambda: fn(runs["parent"][which]), scratch.zero_,
                    pairs=PAIRS)
                print(json.dumps({"pairs": key, "this_vs_parent":
                                  result["pairs"][key]}), flush=True)
            alone = result["alone"].setdefault(key, {})
            for order in (list(runs), list(runs)[::-1]):
                for name in order:
                    alone.setdefault(name, []).append(cs.cuda_median_ms(
                        lambda: fn(runs[name][which]), flush=scratch.zero_))
            print(json.dumps({"alone": key, **alone}), flush=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
