"""Checks and times the bf16 GEMM of the temporal block (csrc/wgmma_bf16.cuh,
rows 8 and 9 in bf16) on the card, for the source as it is and for
variants of it: each variant is a copy of csrc/ under
build/wgmma_variants/<name>/ with its substitutions, built in parallel.

For each variant: the bf16 forward (serving and ``keep`` with its kept
scratch) and backward (dx and the 12 weight gradients, two calls' bits)
against the bf16 plain versions at the main path's shapes and at edge
shapes whose M and N leave partial tiles (n T = 7 x 9 = 63 rows at D=208,
hidden 416, 2 heads; T=81), each error over max |plain|; then, for each
variant that passes, row 8 bf16 at B=256 and row 9 bf16 at B=1024 (CUDA
events, cold L2, medians; against the bf16 TransformerEncoderLayer in
alternating pairs) and each launch's device time
(``chip_smoke.launch_split``); the ptxas summary and the HGMMA count of each
bf16 GEMM entry in the built SASS.

    python3 tools/wgmma_bf16_probe.py OUT.json [VARIANT ...]

Variants: ``source`` (the source as it is); ``stages4_blocks1`` (a
4-deep ring and one thread block an SM); ``mn_swap`` (an MN-major tile's
two descriptor strides exchanged: wrong, a check of the checks);
``label=DIR`` the temporal source of another ``csrc/`` directory, such as
the parent commit's unpacked by ``git archive`` under ``build/``, so that
both designs run in one call. Needs one CUDA card.
"""
import json
import os
import shutil
import subprocess
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from pedestrians_video_2_carla_torch.ops import cuda_build  # noqa: E402
from pedestrians_video_2_carla_torch.ops import \
    fused_temporal_transformer as FT  # noqa: E402

DESCRIPTOR = ("         static_cast<uint64_t>(MN ? 8192 >> 4 : 1) << 16 |\n"
              "         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;")
VARIANTS = {
    "source": (),
    "stages4_blocks1": (("constexpr int kStages = 3;",
                         "constexpr int kStages = 4;"),
                        ("constexpr int kMinBlocks = 2;",
                         "constexpr int kMinBlocks = 1;")),
    "mn_swap": ((DESCRIPTOR,
                 "         static_cast<uint64_t>(MN ? 1024 >> 4 : 1) << 16 |"
                 "\n         static_cast<uint64_t>(MN ? 8192 >> 4 : 1024 >> 4)"
                 " << 32 | 1ull << 62;"),),
}
#: (n, T, D, heads, hidden) of the checks: the edge shapes first
SHAPES = ((7, 9, 208, 2, 416), (253, 9, 832, 8, 1664),
          (cs.PF_BATCH * 8, 9, 832, 8, 1664), (61, 81, 832, 8, 1664))
BWD_SHAPES = ((7, 9, 208, 2, 416), (253, 9, 832, 8, 1664),
              (cs.RF81_BATCH, 81, 832, 8, 1664))


def variant_source(name, fresh=True):
    """The variant's copy of the temporal source (the source itself for
    ``source``), written anew when ``fresh``. A name ``label=DIR`` takes
    the whole of another ``csrc/`` directory (an earlier commit's, from
    ``git archive``), run through this tree's wrapper."""
    if name == "source":
        return FT._SOURCE
    label, _, other = name.partition("=")
    root = cuda_build.BUILD_DIR.parent / "wgmma_variants" / label
    if not fresh:
        return root / FT._SOURCE.name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(other or cuda_build.CSRC, root)
    if not other:
        header = root / "wgmma_bf16.cuh"
        text = header.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in the header")
            text = text.replace(old, new)
        header.write_text(text)
    return root / FT._SOURCE.name


def check(shape, bwd):
    n, T, D, H, hidden = shape
    rng = np.random.default_rng(cs.SEED + 70)
    w = cs.to_bf16(cs.random_block_weights(rng, D, hidden=hidden))
    x = cs.bf16_randn(rng, (n, T, D))
    out = {}
    with torch.no_grad():
        if not bwd:
            got = FT.fused_temporal_block_cuda(x, w, H)
            again = FT.fused_temporal_block_cuda(x, w, H)
            ref = FT.temporal_block_reference(x, w, H)
            out["out"] = [cs.bar_err(got.float(), ref.float())[1],
                          torch.equal(got, again)]
            got_k, saved = FT.fused_temporal_block_cuda(x, w, H, keep=True)
            ref_k, ref_saved = FT.temporal_block_keep_reference(x, w, H)
            for key, a, b in zip(("keep_out",) + cs.FT_SAVED,
                                 (got_k, *saved), (ref_k, *ref_saved)):
                out[key] = cs.bar_err(a.float(), b.float())[1]
            return out
        g = cs.bf16_randn(rng, (n, T, D))
        _, saved = FT.fused_temporal_block_cuda(x, w, H, keep=True)
        dx, dws = FT.fused_temporal_block_cuda_bwd(x, w, saved, g, H)
        dx2, dws2 = FT.fused_temporal_block_cuda_bwd(x, w, saved, g, H)
    ref = cs.plain_grads(lambda t: FT.temporal_block_reference(
        t[0], t[1:], H), [x, *w], g)
    for key, a, b, r in zip(cs.SPATIAL_NAMES, (dx, *dws), (dx2, *dws2), ref):
        out[key] = [cs.bar_err(a.float(), r.float())[1], torch.equal(a, b)]
    return out


def timing():
    rng = np.random.default_rng(cs.SEED + 41)
    wt = cs.to_bf16(cs.random_block_weights(rng, cs.PF_DIM))
    lib = cs.encoder_layer(cs.PF_DIM, wt).to(torch.bfloat16)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush():
        scratch.zero_()
    res = {}
    xt = cs.bf16_randn(rng, (cs.PF_BATCH * 8, cs.PF_RF, cs.PF_DIM))
    with torch.no_grad():
        def fwd():
            return FT.fused_temporal_block_cuda(xt, wt, cs.PF_HEADS)

        def keep():
            return FT.fused_temporal_block_cuda(xt, wt, cs.PF_HEADS,
                                                keep=True)
        res["row8_bf16"] = {
            "ms": cs.cuda_median_ms(fwd, flush=flush),
            "ms_warm_l2": cs.cuda_median_ms(fwd),
            "keep_ms": cs.cuda_median_ms(keep, flush=flush),
            "paired_with_library": cs.paired_ms(fwd, lambda: lib(xt), flush),
            "launch_split": cs.launch_split(fwd, cs.ROW8_STEPS)}
    x = cs.bf16_randn(rng, (cs.BATCH * 8, cs.PF_RF, cs.PF_DIM))
    g = cs.bf16_randn(rng, tuple(x.shape))
    with torch.no_grad():
        _, saved = FT.fused_temporal_block_cuda(x, wt, cs.PF_HEADS, keep=True)

    def bwd():
        return FT.fused_temporal_block_cuda_bwd(x, wt, saved, g, cs.PF_HEADS)
    leaf = x.detach().clone().requires_grad_(True)
    lout = lib(leaf)
    params = [leaf] + list(lib.parameters())
    res["row9_bf16"] = {
        "ms": cs.cuda_median_ms(bwd, flush=flush),
        "ms_warm_l2": cs.cuda_median_ms(bwd),
        "paired_with_library": cs.paired_ms(
            bwd, lambda: torch.autograd.grad(lout, params, g,
                                             retain_graph=True), flush),
        "launch_split": cs.launch_split(bwd, cs.ROW9_STEPS)}
    return res


def sass(library):
    log = library.with_suffix(".log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "wgmma" in ln or ("registers" in ln and "Used" in ln)][:40]
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, current = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
        elif current and "wgmma_bf16_kernel" in current and "HGMMA" in line:
            counts[current[:60]] = counts.get(current[:60], 0) + 1
    return {"ptxas": ptxas, "hgmma_per_entry": counts}


def run(name):
    """One variant's checks and, if they pass, its times: a process of its
    own, so that a fault does not take the other variants with it."""
    FT._SOURCE = variant_source(name, fresh=False)
    lib = cuda_build.build_library(FT._SOURCE)
    entry = {"sass": sass(lib) if "=" not in name else {}}
    ok = True
    for bwd, shapes in ((False, SHAPES), (True, BWD_SHAPES)):
        for shape in shapes:
            key = ("bwd " if bwd else "fwd ") + "x".join(map(str, shape))
            try:
                errs = check(shape, bwd)
                torch.cuda.synchronize()
            except Exception:  # noqa: BLE001 - a probe reports and goes on
                entry[key] = traceback.format_exc()[-1500:]
                ok = False
                break
            entry[key] = errs
            worst = max(v[0] if isinstance(v, list) else v
                        for v in errs.values())
            bits = all(v[1] for v in errs.values() if isinstance(v, list))
            ok = ok and worst <= cs.BF16_BAR and bits
        else:
            continue
        break
    entry["passes"] = ok
    print(json.dumps(entry, default=str)[:8000], flush=True)
    if ok:
        entry["timing"] = timing()
    print("RESULT " + json.dumps(entry, default=str), flush=True)


def main():
    if sys.argv[1] == "--run":
        run(sys.argv[2])
        return
    out_path = sys.argv[1]
    names = sys.argv[2:] or list(VARIANTS)
    report = {"versions": {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": subprocess.run([cuda_build.nvcc(), "--version"],
                               capture_output=True, text=True).stdout[-120:],
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()}}
    print(json.dumps(report), flush=True)
    sources = [variant_source(name) for name in names]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build, sources))
    for name, lib in zip(names, built):
        if isinstance(lib, str):
            report[name] = {"build_error": lib}
            print(json.dumps({name: report[name]}), flush=True)
            continue
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--run", name],
                capture_output=True, text=True, timeout=400)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("RESULT ")]
            report[name] = json.loads(lines[-1][7:]) if lines else {
                "rc": proc.returncode, "stdout": proc.stdout[-3000:],
                "stderr": proc.stderr[-3000:]}
        except subprocess.TimeoutExpired as exc:
            report[name] = {"timeout": str(exc)[-500:]}
        print(json.dumps({name: report[name]}, default=str), flush=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1, default=str)


def _build(source):
    try:
        return cuda_build.build_library(source)
    except Exception as exc:  # noqa: BLE001
        return str(exc)[-4000:]


if __name__ == "__main__":
    main()
