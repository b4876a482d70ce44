"""Times variants of the two kernels redesigned together, the spatial
stack's forward (csrc/fused_spatial_transformer.cu, row 4) and the
projection's training backward (csrc/fused_projection_train.cu, row 3),
against the sources as they are and, given a parent checkout, against the
parent's kernels, on one card. Each code variant is a copy of its source
(with the headers it includes) under build/kernel_variants/<name>/ with
substitutions of the source's lines, built in parallel; row 4's thread-block
sizes need no copy (the C entry takes the frames a thread block). Every
variant is first held to the plain version (row 4: 1e-5 of max |plain|;
row 3: 1e-4 of each gradient's largest magnitude), then timed (CUDA events,
cold L2, medians of 30, two rounds in opposite order).

    python3 tools/spatial_projection_variants.py OUT.json [PARENT_CSRC]

PARENT_CSRC: a parent's pedestrians_video_2_carla_torch/csrc (e.g. from
``git archive <commit> pedestrians_video_2_carla_torch/csrc | tar -x -C
build/parent``), whose two kernels are timed beside the variants through
their own C interfaces. Shapes: row 4 at PoseFormer's serving shape
(N=4096 frames of J=26, E=32, 8 heads, hidden 64, depth 4) and its training
forward (keep) at N=16384; row 3 at B=1024 with L=16, 81 and 1.

Row 4 variants: ``frames1`` .. ``frames8``, thread blocks of that many
frames (the source takes 4, two thread blocks an SM); ``qb4``, four queries
a lane in attention; ``nogroups``, all 32 keys without skipping the groups
past J; ``wide_chunks``, qkv's 96 and fc1's 64 columns in one pass each
(the source: 32 at a time, each pass splitting its A fragments anew). Row 3
variants: ``warps1``, ``warps4``, ``warps8``, that many warps a thread
block (the source: 2); ``frames2``, two frames a warp (the source: 5).
And row 3's phase split: a copy of its source whose thread 0 adds each
phase's ``clock64()`` cycles to a counter (staging, the tree terms, the
carry, the copy out), as shares of all thread blocks' cycles.
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
from pedestrians_video_2_carla_torch.ops import \
    fused_spatial_transformer as FS  # noqa: E402

P = cuda_build.PTR
KG_LOOP = "        if (j0 >= J) break;\n"
#: all of a product's columns in one pass where 96 or 64 of them fit
#: (qkv, fc1), so that each A fragment is split once
WIDE = ("""  int n0 = 0;
  for (; n0 + 8 * kNC <= N; n0 += 8 * kNC)""", """  int n0 = 0;
  for (; n0 + 96 <= N; n0 += 96)
    product_cols<EPI, 12>(A, lda, K, W, ldw, n0, bias, out, ldo, d, keep,
                          cols);
  if (n0 + 64 <= N) {
    product_cols<EPI, 8>(A, lda, K, W, ldw, n0, bias, out, ldo, d, keep,
                         cols);
    n0 += 64;
  }
  for (; n0 + 8 * kNC <= N; n0 += 8 * kNC)""")
SPATIAL = {
    "qb4": (("constexpr int kQB = 2; ", "constexpr int kQB = 4; "),),
    "wide_chunks": (WIDE,),
    "nogroups": ((KG_LOOP + "#pragma unroll\n        for (int j = j0; "
                  "j < j0 + kKG; ++j) {\n          const float4 k",
                  "#pragma unroll\n        for (int j = j0; j < j0 + kKG; "
                  "++j) {\n          const float4 k"),
                 (KG_LOOP + "#pragma unroll\n        for (int j = j0; "
                  "j < j0 + kKG; ++j) {\n          float4 v",
                  "#pragma unroll\n        for (int j = j0; j < j0 + kKG; "
                  "++j) {\n          float4 v")),
}
WARPS = "constexpr int kBwdWarps = 2;"
PROJECTION = {
    "warps1": ((WARPS, "constexpr int kBwdWarps = 1;"),),
    "warps4": ((WARPS, "constexpr int kBwdWarps = 4;"),),
    "warps8": ((WARPS, "constexpr int kBwdWarps = 8;"),),
    "frames2": (("constexpr int kFramesWarp = 5; ",
                 "constexpr int kFramesWarp = 2; "),),
}
#: row 3's phase split: the source with thread 0 of each thread block
#: adding each phase's clock64() cycles to a counter (staging; phase 1, the
#: tree terms; phase 2, the carry; the copy out)
SPLIT = (
    ("namespace {\n", "namespace {\n__device__ long long* g_split = nullptr;"
     "\n#define SPLIT_STAMP(k) if (g_split != nullptr && threadIdx.x == 0) "
     "{ const long long t = clock64(); atomicAdd(reinterpret_cast<unsigned "
     "long long*>(g_split + k), static_cast<unsigned long long>(t - t_last));"
     " t_last = t; }\n"),
    ("    __syncthreads();  // the previous chunk is out of shared memory\n",
     "    __syncthreads();  // the previous chunk is out of shared memory\n"
     "    long long t_last = clock64();\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();\n",
     "    cp_async_wait<0>();\n    __syncthreads();\n    SPLIT_STAMP(0)\n"),
    ("    // ---- phase 2: a thread a (clip, bone), the carry in reverse; each\n",
     "    SPLIT_STAMP(1)\n"
     "    // ---- phase 2: a thread a (clip, bone), the carry in reverse; each\n"),
    ("    // d_changes out, a float a thread, coalesced\n",
     "    SPLIT_STAMP(2)\n    // d_changes out, a float a thread, coalesced\n"),
    ("      d_changes[row0 * 9 + i] = Cm[i];\n",
     "      d_changes[row0 * 9 + i] = Cm[i];\n    __syncthreads();\n"
     "    SPLIT_STAMP(3)\n"),
)
SPLIT_SET = """
extern "C" int pv2c_split_set(long long* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_split, &p, sizeof(p)));
}
"""
SPLIT_PHASES = ("stage", "tree_terms", "carry", "copy_out")
SPATIAL_FRAMES = (1, 2, 3, 4, 5, 6, 8)
PROJECTION_SHAPES = ((1024, 16), (1024, 81), (1024, 1))


def variant_source(source, name, subs):
    text = source.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is not one place of "
                             f"the source")
        text = text.replace(old, new)
    d = cuda_build.BUILD_DIR.parent / "kernel_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / source.name).write_text(text)
    for header in cuda_build._local_headers(source):
        shutil.copy(header, d / header.name)
    return d / source.name


def load(path, signatures):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
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
    sources = {("spatial", "source"): FS._SOURCE,
               ("projection", "source"): FP._TRAIN_SOURCE}
    for name, subs in SPATIAL.items():
        sources[("spatial", name)] = variant_source(FS._SOURCE, name, subs)
    for name, subs in PROJECTION.items():
        sources[("projection", name)] = variant_source(FP._TRAIN_SOURCE,
                                                       name, subs)
    split = variant_source(FP._TRAIN_SOURCE, "split", SPLIT)
    split.write_text(split.read_text() + SPLIT_SET)
    sources[("projection_split", "split")] = split
    if parent is not None:
        for kind, file in (("spatial", FS._SOURCE.name),
                           ("projection", FP._TRAIN_SOURCE.name)):
            sources[(kind, "parent")] = variant_source(parent / file,
                                                       "parent_" + kind, ())
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(cuda_build.build_library,
                                           sources.values())))
    result = {"card": card, "spatial": {}, "projection": {}}
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def timed(fn):
        return cs.cuda_median_ms(fn, flush=scratch.zero_)

    # ---- row 4 ----
    rng = np.random.default_rng(cs.SEED + 3)
    ws = cs.random_spatial_weights(rng)
    xs = {n: torch.from_numpy(rng.standard_normal(
        (n, cs.PF_JOINTS, cs.PF_EMB)).astype(np.float32)).cuda()
        for n in (cs.SPATIAL_NS[0], cs.SPATIAL_BWD_NS[0])}
    ref = FS.spatial_stack_reference(xs[cs.SPATIAL_NS[0]], ws, cs.PF_HEADS)
    runs = {}
    for kind, name in built:
        if kind != "spatial":
            continue
        lib = cs.spatial_library(sources[(kind, name)])
        frames_list = SPATIAL_FRAMES if name == "source" else (4,)
        for frames in frames_list:
            label = f"frames{frames}" if name == "source" else name
            runs[label] = (lib, frames)
    for order in (list(runs), list(runs)[::-1]):
        for label in order:
            lib, frames = runs[label]
            row = result["spatial"].setdefault(label, {"frames": frames})
            x = xs[cs.SPATIAL_NS[0]]
            got = cs.spatial_launch(lib, x, ws, cs.PF_HEADS, frames, False)
            row["max_err_over_max_plain"] = cs.bar_err(got, ref)[1]
            if row["max_err_over_max_plain"] > cs.KERNEL_BAR:
                row["error"] = "disagrees with the plain version"
                continue
            row.setdefault("ms", []).append(timed(lambda: cs.spatial_launch(
                lib, x, ws, cs.PF_HEADS, frames, False)))
            x = xs[cs.SPATIAL_BWD_NS[0]]
            row.setdefault("keep_ms_n16384", []).append(timed(
                lambda: cs.spatial_launch(lib, x, ws, cs.PF_HEADS, frames,
                                          True)))
            print(json.dumps({"spatial": label, **row}), flush=True)

    # ---- row 3 ----
    cam = C.make_camera()
    libs = {name: load(path, FP._SIGNATURES["train"])
            for (kind, name), path in built.items() if kind == "projection"}
    for B, L in PROJECTION_SHAPES:
        args = cs.kernel_inputs(rng, B, L, "cuda")
        _, _, states = FP.fused_projection_train_cuda_fwd(*args, cam)
        g = [torch.from_numpy(rng.standard_normal((B, L, 26, 3)).astype(
            np.float32)).cuda() for _ in range(2)]
        refs = FP.fused_projection_train_bwd_reference(*args, states, *g,
                                                       cam)

        def run(lib):
            outs = tuple(torch.empty_like(t) for t in args)
            FP._launch(lib.pv2c_fused_projection_train_bwd, args[0].device,
                       *args, states, *g, *outs, B, L, cam)
            return outs
        # the source's phases, one launch with the stamps on
        lib = load(built[("projection_split", "split")],
                   {**FP._SIGNATURES["train"], "pv2c_split_set": [P]})
        cycles = torch.zeros(len(SPLIT_PHASES), dtype=torch.int64,
                             device="cuda")
        lib.pv2c_split_set(cycles.data_ptr())
        run(lib)
        torch.cuda.synchronize()
        lib.pv2c_split_set(None)
        total = float(cycles.sum())
        result.setdefault("projection_split", {})[f"B{B}_L{L}"] = {
            name: c / total for name, c in zip(SPLIT_PHASES,
                                               cycles.tolist())}
        print(json.dumps({"projection_split": f"B{B}_L{L}", **result[
            "projection_split"][f"B{B}_L{L}"]}), flush=True)
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                row = result["projection"].setdefault(name, {}).setdefault(
                    f"B{B}_L{L}", {})
                worst = max(cs.scaled_err(a, r)[0]
                            for a, r in zip(run(libs[name]), refs))
                row["max_scaled_err"] = worst
                if worst > cs.GRAD_RTOL:
                    row["error"] = "disagrees with the plain version"
                    continue
                row.setdefault("ms", []).append(timed(
                    lambda: run(libs[name])))
                print(json.dumps({"projection": name, "B": B, "L": L,
                                  **row}), flush=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
