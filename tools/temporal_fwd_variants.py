"""Times variants of the temporal block's forward (the 3xTF32 GEMM of
csrc/fused_temporal_transformer.cu) on the card against the source as it
is: each variant is a copy of the source (with the headers it includes)
under build/temporal_variants/<name>/ with its substitutions of the forward
GEMM's plan constants or of the kernel's lines, built in parallel. Each
variant's forward is first held to the plain version (output and kept
scratch within 1e-5 of max |plain|, at the main path's shape and a ragged
one), then timed (CUDA events, cold L2, medians) at PoseFormer's serving
shape (B=256, L=16: 2048 windows of 9 tokens, D=832, 8 heads), serving and
training (``keep``), in two rounds of opposite order.

    python3 tools/temporal_fwd_variants.py OUT.json

Variants, each against the source's plan (128 x 128 thread-block tiles of
four 64 x 64 warp tiles, 32-deep k-steps, a 3-deep ring, two thread blocks
an SM, fragments read one float a load): ``ldsm`` fragments read with
ldmatrix, four 8 x 4 blocks an instruction; ``wn32`` 64 x 32 warp tiles
(8 warps); ``bk16`` 16-deep k-steps; ``stages2`` / ``stages4`` a 2- /
4-deep ring; ``blocks1`` one thread block an SM in the launch bounds;
``bn256`` 128 x 256 thread-block tiles (8 warps, one thread block an
SM); ``presplit`` tiles split into their two TF32 planes once in shared
memory; ``first`` the first plan tried (64 x 32 warp tiles, 16-deep
k-steps); ``inner16`` / ``inner32`` the three
products summed in the tensor cores over 16 / 32 of k (instead of each
8-deep step) before the fp32 add; ``cvt`` the TF32 split's big part by
cvt.rna.tf32.f32; ``wn32_blocks1`` 64 x 32 warp tiles with one thread
block an SM (no register cap of 128); ``bn64_blocks3`` 128 x 64
thread-block tiles of four 64 x 32 warp tiles, 16-deep k-steps, three
thread blocks an SM. Then the source's per-launch split
(``chip_smoke.launch_split``). Needs one CUDA card.
"""
import json
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from pedestrians_video_2_carla_torch.ops import cuda_build  # noqa: E402
from pedestrians_video_2_carla_torch.ops import \
    fused_temporal_transformer as FT  # noqa: E402

WN32 = ("constexpr int kFWM = 64, kFWN = 64;",
        "constexpr int kFWM = 64, kFWN = 32;")
BK16 = ("constexpr int kFBK = 32;", "constexpr int kFBK = 16;")
BLOCKS1 = ("constexpr int kFMinBlocks = 2;", "constexpr int kFMinBlocks = 1;")

# The variants that change the forward GEMM's code rather than its plan:
# each is a set of substitutions of the kernel's own lines, with helpers
# put in before the kernel.
KERNEL = "// C = epi(A W^T + bias). K a multiple of 8, N of 8, pointers"
W_SPLITS = ("        split_tf32(w[0], bb[j][0], bs[j][0]);\n"
            "        split_tf32(w[4], bb[j][1], bs[j][1]);\n")
A_SPLITS = ("        split_tf32(a[0], ab[0], as[0]);\n"
            "        split_tf32(a[8 * kFLd], ab[1], as[1]);\n"
            "        split_tf32(a[4], ab[2], as[2]);\n"
            "        split_tf32(a[8 * kFLd + 4], ab[3], as[3]);\n")


def _helper(code):
    return (KERNEL, code + "\n" + KERNEL)


#: ldmatrix: four 8 x 4 fp32 blocks of shared memory (as ldmatrix's 8 x 8
#: b16 matrices) into one register each; lane l gives row l % 8 of block
#: l / 8 and lane i receives element [i / 4][i % 4] of each block, the
#: m16n8k8 TF32 fragment layout
LDSM = (
    _helper("""__device__ __forceinline__ void ldsm_x4(unsigned* r,
                                        const float* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
"""),
    ("      for (int j = 0; j < kNT; ++j) {\n"
     "        const float* w = Ws + (wn + j * 8 + gq) * kFLd + ks + tq;\n"
     + W_SPLITS + "      }\n",
     # blocks: n-tile j's k-halves, then n-tile j + 1's
     """      for (int j = 0; j < kNT; j += 2) {
        const int q = lane >> 3;
        unsigned r[4];
        ldsm_x4(r, Ws + (wn + (j + (q >> 1)) * 8 + (lane & 7)) * kFLd + ks +
                       (q & 1) * 4);
        split_tf32(__uint_as_float(r[0]), bb[j][0], bs[j][0]);
        split_tf32(__uint_as_float(r[1]), bb[j][1], bs[j][1]);
        split_tf32(__uint_as_float(r[2]), bb[j + 1][0], bs[j + 1][0]);
        split_tf32(__uint_as_float(r[3]), bb[j + 1][1], bs[j + 1][1]);
      }
"""),
    ("        const float* a = As + (wm + i * 16 + gq) * kFLd + ks + tq;\n"
     "        unsigned ab[4], as[4];\n" + A_SPLITS,
     # blocks: rows m.., m + 8.. at k, then the same at k + 4
     """        const int q = lane >> 3;
        unsigned ab[4], as[4], r[4];
        ldsm_x4(r, As + (wm + i * 16 + (q & 1) * 8 + (lane & 7)) * kFLd + ks +
                       (q >> 1) * 4);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          split_tf32(__uint_as_float(r[c]), ab[c], as[c]);
"""))

#: presplit: a landed tile split into its two TF32 planes once, in shared
#: memory (the small plane kFTileFloats further on), each warp then reading
#: both planes
PRESPLIT = (
    ("constexpr int kFStageFloats = (kFBM + kFBN) * kFLd;  "
     "// an A and a W tile",
     "constexpr int kFTileFloats = (kFBM + kFBN) * kFLd;\n"
     "constexpr int kFStageFloats = 2 * kFTileFloats;"),
    _helper("""__device__ __forceinline__ void planes(const float* at,
                                       unsigned& big, unsigned& small) {
  big = __float_as_uint(at[0]);
  small = __float_as_uint(at[kFTileFloats]);
}
"""),
    ("    const float* As = smem + (step % kFStages) * kFStageFloats;\n",
     """    float* As = smem + (step % kFStages) * kFStageFloats;
    for (int e = tid; e < kFTileFloats; e += kFThreads) {
      unsigned big, small;
      split_tf32(As[e], big, small);
      As[e] = __uint_as_float(big);
      As[e + kFTileFloats] = __uint_as_float(small);
    }
    __syncthreads();
"""),
    (W_SPLITS, W_SPLITS.replace("split_tf32(w[0]", "planes(w")
     .replace("split_tf32(w[4]", "planes(w + 4")),
    (A_SPLITS, A_SPLITS.replace("split_tf32(a[0]", "planes(a")
     .replace("split_tf32(a[8 * kFLd]", "planes(a + 8 * kFLd")
     .replace("split_tf32(a[4]", "planes(a + 4")
     .replace("split_tf32(a[8 * kFLd + 4]", "planes(a + 8 * kFLd + 4")))

#: cvt: the TF32 split's big part from cvt.rna.tf32.f32 (the same rounding,
#: one instruction)
CVT = (
    _helper("""__device__ __forceinline__ void split_cvt(float x, unsigned& big,
                                          unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));
  small = __float_as_uint(x - __uint_as_float(big));
}
"""),
    (W_SPLITS, W_SPLITS.replace("split_tf32", "split_cvt")),
    (A_SPLITS, A_SPLITS.replace("split_tf32", "split_cvt")))


def inner(k):
    """The three products summed in the tensor cores over ``k`` of K
    (instead of each 8-deep step) before the fp32 add."""
    return (
        ("  float acc[kMT][kNT][4];\n",
         "  float acc[kMT][kNT][4], inner[kMT][kNT][4] = {};\n"),
        ("          mma_3xtf32(acc[i][j], ab, as, bb[j], bs[j]);\n      }\n",
         f"""          {{
            mma_tf32(inner[i][j], as, bb[j]);
            mma_tf32(inner[i][j], ab, bs[j]);
            mma_tf32(inner[i][j], ab, bb[j]);
          }}
      }}
      if ((ks + 8) % {k} == 0) {{
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {{
              acc[i][j][c] += inner[i][j][c];
              inner[i][j][c] = 0.f;
            }}
      }}
"""))


VARIANTS = {
    "base": (),
    "ldsm": LDSM,
    "wn32": (WN32,),
    "bk16": (BK16,),
    "stages2": (("constexpr int kFStages = 3;",
                 "constexpr int kFStages = 2;"),),
    "stages4": (("constexpr int kFStages = 3;",
                 "constexpr int kFStages = 4;"),),
    "blocks1": (BLOCKS1,),
    "bn256": (("constexpr int kFBM = 128, kFBN = 128;",
               "constexpr int kFBM = 128, kFBN = 256;"), BLOCKS1),
    "presplit": PRESPLIT,
    "first": (WN32, BK16),
    "inner16": inner(16),
    "inner32": inner(32),
    "cvt": CVT,
    "wn32_blocks1": (WN32, BLOCKS1),
    "bn64_blocks3": (("constexpr int kFBM = 128, kFBN = 128;",
                      "constexpr int kFBM = 128, kFBN = 64;"), WN32, BK16,
                     ("constexpr int kFMinBlocks = 2;",
                      "constexpr int kFMinBlocks = 3;")),
}
NS = (cs.TEMPORAL_NS[0], cs.TEMPORAL_NS[1])


def variant_sources():
    text = FT._SOURCE.read_text()
    sources = {}
    for name, subs in VARIANTS.items():
        if not subs:
            sources[name] = FT._SOURCE
            continue
        variant = text
        for old, new in subs:
            if variant.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} is not one "
                                 f"place of the source")
            variant = variant.replace(old, new)
        d = cuda_build.BUILD_DIR.parent / "temporal_variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / FT._SOURCE.name).write_text(variant)
        for header in cuda_build._local_headers(FT._SOURCE):
            shutil.copy(header, d / header.name)
        sources[name] = d / FT._SOURCE.name
    return sources


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card, _ = cs.phase_device()
    sources = variant_sources()

    def build(source):
        try:
            return cuda_build.build_library(source)
        except RuntimeError as e:  # a variant that does not build is a result
            return e
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources.values())))
    out = {"card": card, "variants": {}}
    libs = {}
    for name, path in built.items():
        if isinstance(path, Exception):
            out["variants"][name] = {"build_error": str(path)[-2000:]}
            continue
        libs[name] = _load(path)
        log = path.with_suffix(".log")
        out["variants"][name] = {"ptxas": [
            ln.strip() for ln in (log.read_text() if log.exists() else ""
                                  ).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]}

    rng = np.random.default_rng(cs.SEED + 21)
    weights = cs.random_block_weights(rng, cs.PF_DIM)
    xs = {n: torch.from_numpy(rng.standard_normal(
        (n, cs.PF_RF, cs.PF_DIM)).astype(np.float32)).cuda() for n in NS}
    refs = {n: FT.temporal_block_keep_reference(x, weights, cs.PF_HEADS)
            for n, x in xs.items()}
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    x = xs[NS[0]]
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            cuda_build._loaded[FT._SOURCE] = libs[name]
            row = out["variants"][name]
            try:
                worst = 0.0
                for n, xn in xs.items():
                    got, saved = FT.fused_temporal_block_cuda(
                        xn, weights, cs.PF_HEADS, keep=True)
                    ref, ref_saved = refs[n]
                    for a, b in zip((got, *saved), (ref, *ref_saved)):
                        worst = max(worst, cs.bar_err(a, b)[1])
                if worst > cs.KERNEL_BAR:
                    raise AssertionError(f"{worst} of max |plain|")
                row.setdefault("max_err_over_max_plain", worst)
                row.setdefault("ms", []).append(cs.cuda_median_ms(
                    lambda: FT.fused_temporal_block_cuda(x, weights,
                                                         cs.PF_HEADS),
                    flush=flush))
                row.setdefault("keep_ms", []).append(cs.cuda_median_ms(
                    lambda: FT.fused_temporal_block_cuda(
                        x, weights, cs.PF_HEADS, keep=True), flush=flush))
            except (RuntimeError, AssertionError) as e:
                row["error"] = str(e)[-500:]
            print(json.dumps({"variant": name, **{
                k: v for k, v in row.items() if k != "ptxas"}}), flush=True)
    if "base" in libs:  # where the source's block spends its time
        cuda_build._loaded[FT._SOURCE] = libs["base"]
        out["base_launch_split"] = cs.launch_split(
            lambda: FT.fused_temporal_block_cuda(x, weights, cs.PF_HEADS),
            cs.ROW8_STEPS)
        print(json.dumps({"base_launch_split": out["base_launch_split"]}),
              flush=True)
    cuda_build._loaded.pop(FT._SOURCE, None)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f, indent=1)


def _load(path):
    """A variant's library, loaded beside the source's with the same
    argument types."""
    import ctypes
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in FT._SIGNATURES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    main()
