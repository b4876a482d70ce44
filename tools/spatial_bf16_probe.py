"""Holds the spatial stack's bf16 kernels (rows 4 and 5 in bf16,
csrc/fused_spatial_transformer.cu) of this checkout against another
commit's on the card, in one process: each design is a package directory
(this checkout's, or an earlier commit's unpacked by ``git archive``),
imported under a name of its own so that its wrapper drives its own
library.

For each design, in a process of its own (a fault does not take the
others): the bf16 forward (serving and ``keep``: the same output, the kept
residuals finite) and backward (dx and the 14 weight gradients, two calls'
bits) at the main path's shapes (B=256 and B=1024, L=16: 4096 and 16,384
frames of 26 tokens, E=32, 8 heads, hidden 64, depth 4), at
chip_smoke.SPATIAL_WIDE's and at chip_smoke.SPATIAL_EDGE's, each error over
max |bf16 plain| (bar chip_smoke.BF16_BAR), the backward also against the
float32 plain algorithm (``spatial_stack_bwd_reference``, this checkout's)
from the same residuals (bar chip_smoke.BF16_BWD_BAR, 2^-8). Then, for the
designs that pass: rows 4 and 5 in bf16 and in float32 in 10 alternating
rounds (each design once a round, the order reversed every other round;
CUDA events, cold L2; medians), row 4 bf16's training forward (``keep``) at
B=1024 too; the float32 outputs' bits of each design against the first's;
row 5 bf16's launches (``chip_smoke.launch_split``) and phases (a
``clock64()`` stamp by thread 0 after each barrier of its kernels, in an
instrumented copy of the design's source, summed over thread blocks), row 4
bf16's phases (``chip_smoke.spatial_phase_split`` on an instrumented copy),
serving at B=256 and ``keep`` at B=1024; the bf16
TransformerEncoderLayer yardsticks once.

    mkdir -p build/parent
    git archive HEAD pedestrians_video_2_carla_torch | tar -x -C build/parent
    python3 tools/spatial_bf16_probe.py OUT.json source \\
        parent=build/parent/pedestrians_video_2_carla_torch

A design is ``source`` (this checkout) or ``NAME=DIR``. Needs one CUDA
card.
"""
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from pedestrians_video_2_carla_torch.ops import \
    fused_spatial_transformer as FS  # noqa: E402

ROOT = Path(os.getcwd()) / "build" / "spatial_probe"
ROUNDS = 10
HID = 2 * cs.PF_EMB


def design_module(name):
    """The design's wrapper module: this checkout's for ``source``, else
    the package of ``NAME=DIR`` copied under build/spatial_probe/NAME as
    ``pv2c_probe_NAME`` and imported so."""
    if name == "source":
        return FS
    label, _, src = name.partition("=")
    pkg = f"pv2c_probe_{label}"
    home = ROOT / label
    if not (home / pkg).exists():
        shutil.copytree(src, home / pkg)
    if str(home) not in sys.path:
        sys.path.insert(0, str(home))
    return importlib.import_module(f"{pkg}.ops.fused_spatial_transformer")


def split_copy(mod, label):
    """The design's source with its bf16 forward instrumented, under
    build/spatial_probe/<label>/split/; (path, design)."""
    text, design = cs.instrument_spatial_forward(mod._SOURCE.read_text(),
                                                 bf16=True)
    d = ROOT / label.partition("=")[0] / "split"
    d.mkdir(parents=True, exist_ok=True)
    copy = d / mod._SOURCE.name
    copy.write_text(text)
    for header in mod._SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    return copy, design


#: the bf16 backward's kernels in a source: its own section, or (an earlier
#: design) the float32 backward's templates
BWD_SECTIONS = (("// Backward, bf16", "bool valid("),
                ("// Backward: dx", "bool valid("))
BWD_SLOTS = 4096
BWD_HELPERS = """
__device__ unsigned long long* g_bwd_clk = nullptr;
__device__ int* g_bwd_n = nullptr;
__device__ __forceinline__ void bwd_stamp(int site) {
  if (threadIdx.x == 0 && g_bwd_clk != nullptr) {
    const int i = g_bwd_n[blockIdx.x]++;
    if (i < %d) {
      g_bwd_clk[2 * (blockIdx.x * %d + i)] = site;
      g_bwd_clk[2 * (blockIdx.x * %d + i) + 1] = clock64();
    }
  }
}
""" % (BWD_SLOTS, BWD_SLOTS, BWD_SLOTS)
BWD_SET = """
extern "C" int pv2c_bwd_split_set(unsigned long long* clk, int* n) {
  cudaError_t e = cudaMemcpyToSymbol(g_bwd_clk, &clk, sizeof(clk));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_bwd_n, &n, sizeof(n));
  return static_cast<int>(e);
}
"""


def bwd_split_copy(mod, label):
    """The design's source with a stamp (thread 0: the site's number and
    clock64()) at each bf16 backward kernel's start and after each of its
    barriers, under build/spatial_probe/<label>/bwd_split/; returns the
    path and each site's kernel and the code before it."""
    import re
    text = mod._SOURCE.read_text()
    start, end = next(sec for sec in BWD_SECTIONS if sec[0] in text)
    head, rest = text[:text.index(start)], text[text.index(start):]
    body, tail = rest[:rest.index(end)], rest[rest.index(end):]
    sites, out, kernel = [], [], "?"
    for line in body.splitlines(keepends=True):
        m = re.search(r"^\s+(spatial_\w+_kernel)\(", line)
        if m:
            kernel = m.group(1)
        out.append(line)
        stripped = line.strip()
        if stripped.startswith("extern __shared__") or stripped.startswith(
                "__syncthreads();"):
            before = [ln.strip() for ln in out[-4:-1] if ln.strip()]
            out.append(f"  bwd_stamp({len(sites)});\n")
            sites.append({"kernel": kernel, "after": stripped[:40],
                          "code_before": before[-2:]})
    head = head.replace("namespace {\n", "namespace {\n" + BWD_HELPERS, 1)
    d = ROOT / label.partition("=")[0] / "bwd_split"
    d.mkdir(parents=True, exist_ok=True)
    copy = d / mod._SOURCE.name
    copy.write_text(head + "".join(out) + tail + BWD_SET)
    for header in mod._SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    return copy, sites


def bwd_phase_split(mod, label, x, ws, saved, g, H, ms):
    """One backward call of the design through its instrumented copy: each
    site's cycles (from the stamp before it in the same launch, summed over
    thread blocks), its share of its kernel's, and that share of the
    kernel's part of ``ms`` (by its cycles)."""
    import ctypes
    from pedestrians_video_2_carla_torch.ops import cuda_build
    copy, sites = bwd_split_copy(mod, label)
    lib = ctypes.CDLL(str(cuda_build.build_library(copy)))
    for name, argtypes in mod._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
    lib.pv2c_bwd_split_set.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    blocks = 4096
    clk = torch.zeros((blocks, BWD_SLOTS, 2), dtype=torch.int64,
                      device="cuda")
    n = torch.zeros(blocks, dtype=torch.int32, device="cuda")
    cuda_build.check_launch(lib.pv2c_bwd_split_set(clk.data_ptr(),
                                                   n.data_ptr()), "split")
    keep = mod._library
    mod._library = lambda: lib
    try:
        with torch.no_grad():
            mod.fused_spatial_stack_cuda_bwd(x, ws, saved, g, H)
        torch.cuda.synchronize()
    finally:
        mod._library = keep
        lib.pv2c_bwd_split_set(None, None)
    counts, data = n.cpu().tolist(), clk.cpu().numpy()
    cycles = [0] * len(sites)
    for b, count in enumerate(counts):
        if count > BWD_SLOTS:
            raise AssertionError(f"block {b}: {count} stamps")
        seq = data[b, :count]
        for (s0, c0), (s1, c1) in zip(seq[:-1], seq[1:]):
            if sites[s1]["kernel"] == sites[s0]["kernel"] and \
                    "extern" not in sites[s1]["after"]:
                cycles[s1] += int(c1 - c0)
    by_kernel = {}
    for site, c in zip(sites, cycles):
        by_kernel[site["kernel"]] = by_kernel.get(site["kernel"], 0) + c
    total = sum(by_kernel.values())
    return [{**site, "cycles": c,
             "share_of_kernel": c / max(by_kernel[site["kernel"]], 1),
             "ms": ms * c / max(total, 1)}
            for site, c in zip(sites, cycles) if c]


def tiles(mod, J, E, H, hidden, bf16):
    """The design's tiles for the dtype (an earlier wrapper has one set)."""
    try:
        return mod.kernel_tiles(J, E, H, hidden, element_size=2 if bf16
                                else 4)
    except TypeError:
        return mod.kernel_tiles(J, E, H, hidden)


def bf16_weights(rng, E=cs.PF_EMB, hidden=None):
    return cs.to_bf16(cs.random_spatial_weights(rng, E, hidden))


def check_case(mod, J, E, H, hidden, n, bwd):
    """Errors of one design at one shape: {what: [err over max |ref|,
    same bits twice]}."""
    rng = np.random.default_rng(cs.SEED + 90 + E + J)
    ws = bf16_weights(rng, E, hidden)
    x = cs.bf16_randn(rng, (n, J, E))
    g = cs.bf16_randn(rng, (n, J, E))
    out = {}
    with torch.no_grad():
        y = mod.fused_spatial_stack_cuda(x, ws, H)
        y2 = mod.fused_spatial_stack_cuda(x, ws, H)
        yk, saved = mod.fused_spatial_stack_cuda(x, ws, H, keep=True)
        ref = FS.spatial_stack_reference(x, ws, H)
    out["out"] = [cs.bar_err(y.float(), ref.float())[1],
                  torch.equal(y, y2) and torch.equal(y, yk)]
    out["saved_finite"] = [0.0, all(bool(torch.isfinite(t).all())
                                    for t in saved)]
    if not bwd:
        return out
    with torch.no_grad():
        dx, dws = mod.fused_spatial_stack_cuda_bwd(x, ws, saved, g, H)
        dx2, dws2 = mod.fused_spatial_stack_cuda_bwd(x, ws, saved, g, H)
        exact = FS.spatial_stack_bwd_reference(
            x.float(), [w.float() for w in ws], saved, g.float(), H)
    plain = cs.plain_grads(lambda t: FS.spatial_stack_reference(
        t[0], t[1:], H), [x, *ws], g)
    for name, a, b, r, e in zip(cs.SPATIAL_NAMES, (dx, *dws), (dx2, *dws2),
                                plain, (exact[0], *exact[1])):
        out[name] = [cs.bar_err(a.float(), r.float())[1], torch.equal(a, b),
                     cs.bar_err(a.float(), e)[1]]
    return out


CASES = ([(cs.PF_JOINTS, cs.PF_EMB, cs.PF_HEADS, HID, cs.PF_BATCH * cs.CLIP,
           False),
          (cs.PF_JOINTS, cs.PF_EMB, cs.PF_HEADS, HID, cs.BATCH * cs.CLIP,
           True)]
         + [(cs.PF_JOINTS, e, h, 2 * e, n, True)
            for e, h in cs.SPATIAL_WIDE for n in cs.SPATIAL_WIDE_NS]
         + [(J, e, h, hid, cs.SPATIAL_EDGE_N, True)
            for J, e, h, hid in cs.SPATIAL_EDGE])


def check(name):
    """One design's checks, a JSON line on stdout."""
    mod = design_module(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    entry, ok = {}, True
    for J, E, H, hidden, n, bwd in CASES:
        key = f"J{J} E{E} H{H} hidden{hidden} N{n}"
        try:
            errs = check_case(mod, J, E, H, hidden, n, bwd)
            torch.cuda.synchronize()
        except Exception:  # noqa: BLE001 - a probe reports and goes on
            entry[key] = traceback.format_exc()[-2000:]
            ok = False
            break
        entry[key] = errs
        ok = ok and all(v[1] for v in errs.values()) and all(
            v[0] <= cs.BF16_BAR for v in errs.values())
    entry["passes"] = ok
    entry["worst_vs_fp32_algorithm"] = max(
        (v[2] for case in entry.values() if isinstance(case, dict)
         for v in case.values() if len(v) > 2), default=None)
    print("RESULT " + json.dumps(entry, default=str), flush=True)


def rounds(fns, flush):
    """``fns`` (name -> call) in ROUNDS alternating rounds (the order
    reversed every other round), cold L2: each one's median."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    times = {k: [] for k in fns}
    order = list(fns)
    for i in range(ROUNDS):
        for k in (order if i % 2 == 0 else order[::-1]):
            times[k].append(cs.cuda_call_ms(fns[k], flush))
    return {k: statistics.median(v) for k, v in times.items()}


def timing(names, card):
    mods = {n: design_module(n) for n in names}
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush():
        scratch.zero_()
    rng = np.random.default_rng(cs.SEED + 41)
    w32 = cs.random_spatial_weights(rng)
    w16 = cs.to_bf16(w32)
    x_s = cs.bf16_randn(rng, (cs.PF_BATCH * cs.CLIP, cs.PF_JOINTS,
                              cs.PF_EMB))
    x_t = cs.bf16_randn(rng, (cs.BATCH * cs.CLIP, cs.PF_JOINTS, cs.PF_EMB))
    g_t = cs.bf16_randn(rng, tuple(x_t.shape))
    res = {"card": card}
    H = cs.PF_HEADS
    with torch.no_grad():
        res["row4_bf16"] = rounds({n: (lambda m=m: m.fused_spatial_stack_cuda(
            x_s, w16, H)) for n, m in mods.items()}, flush)
        res["row4_bf16_keep_B1024"] = rounds(
            {n: (lambda m=m: m.fused_spatial_stack_cuda(x_t, w16, H,
                                                        keep=True))
             for n, m in mods.items()}, flush)
        saved = {n: m.fused_spatial_stack_cuda(x_t, w16, H, keep=True)[1]
                 for n, m in mods.items()}
        res["row5_bf16"] = rounds(
            {n: (lambda m=m, n=n: m.fused_spatial_stack_cuda_bwd(
                x_t, w16, saved[n], g_t, H)) for n, m in mods.items()},
            flush)
        res["row5_bf16_launch_split"] = {
            n: cs.launch_split(lambda m=m, n=n: m.fused_spatial_stack_cuda_bwd(
                x_t, w16, saved[n], g_t, H), cs.ROW5_STEPS)
            for n, m in mods.items()}
        res["row5_bf16_phase_split"] = {
            n: bwd_phase_split(m, n, x_t, w16, saved[n], g_t, H,
                               res["row5_bf16"][n])
            for n, m in mods.items()}
        del saved
        x_s32, x_t32, g_t32 = x_s.float(), x_t.float(), g_t.float()
        res["row4"] = rounds({n: (lambda m=m: m.fused_spatial_stack_cuda(
            x_s32, w32, H)) for n, m in mods.items()}, flush)
        saved = {n: m.fused_spatial_stack_cuda(x_t32, w32, H, keep=True)[1]
                 for n, m in mods.items()}
        res["row5"] = rounds(
            {n: (lambda m=m, n=n: m.fused_spatial_stack_cuda_bwd(
                x_t32, w32, saved[n], g_t32, H)) for n, m in mods.items()},
            flush)
        first = names[0]
        outs = {n: m.fused_spatial_stack_cuda(x_s32, w32, H)
                for n, m in mods.items()}
        grads = {n: m.fused_spatial_stack_cuda_bwd(x_t32, w32, saved[n],
                                                   g_t32, H)
                 for n, m in mods.items()}
        res["fp32_same_bits_as_" + first] = {
            n: torch.equal(outs[n], outs[first]) and all(
                torch.equal(a, b) for a, b in zip(
                    (grads[n][0], *grads[n][1]),
                    (grads[first][0], *grads[first][1])))
            for n in names}
        del saved, outs, grads
        lib = cs.spatial_encoder_stack(w16).to(torch.bfloat16)
        res["library_row4_bf16_ms"] = cs.cuda_median_ms(lambda: lib(x_s),
                                                        flush=flush)
    leaf = x_t.detach().clone().requires_grad_(True)
    lout = lib(leaf)
    params = [leaf] + list(lib.parameters())
    res["library_row5_bf16_ms"] = cs.cuda_median_ms(
        lambda: torch.autograd.grad(lout, params, g_t, retain_graph=True),
        flush=flush)
    del lout, params, leaf
    for n, m in mods.items():
        copy, design = split_copy(m, n)
        frames = tiles(m, cs.PF_JOINTS, cs.PF_EMB, H, HID, True)[0]
        for what, x, keep, ms in (
                ("serve_B256", x_s, False, res["row4_bf16"][n]),
                ("keep_B1024", x_t, True, res["row4_bf16_keep_B1024"][n])):
            split, stamped = cs.spatial_phase_split(copy, design, x, w16, H,
                                                    frames, keep, ms)
            with torch.no_grad():
                same = torch.equal(stamped, m.fused_spatial_stack_cuda(
                    x, w16, H))
            res.setdefault("row4_bf16_phase_split", {}).setdefault(n, {})[
                what] = {"same_bits_as_the_kernel": same,
                         "frames_a_thread_block": frames, **split}
    return res


def build(name):
    """Builds the design's library and its instrumented copy; returns the
    ptxas lines of the spatial kernels (registers, spills) or the
    error."""
    mod = design_module(name)
    try:
        mod._library()
        from pedestrians_video_2_carla_torch.ops import cuda_build
        cuda_build.build_library(split_copy(mod, name)[0])
        cuda_build.build_library(bwd_split_copy(mod, name)[0])
        log = Path(str(mod.cuda_build.library_path(mod._SOURCE))).with_suffix(
            ".log")
        lines = log.read_text().splitlines() if log.exists() else []
        return [ln.strip()[:160] for ln in lines
                if "Compiling entry" in ln or "registers" in ln
                or "spill" in ln]
    except Exception as exc:  # noqa: BLE001
        return "build error: " + str(exc)[-4000:]


def main():
    if sys.argv[1] == "--check":
        check(sys.argv[2])
        return
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out_path, names = sys.argv[1], sys.argv[2:] or ["source"]
    card, _ = cs.phase_device()
    report = {"versions": {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "card": card}}
    for name in names:  # imported one at a time: each registers its ops
        design_module(name)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
        builds = list(pool.map(build, names))
    passed = []
    for name, built in zip(names, builds):
        if isinstance(built, str):
            report[name] = {"build_error": built}
        else:
            try:
                proc = subprocess.run(
                    [sys.executable, __file__, "--check", name],
                    capture_output=True, text=True, timeout=600)
                lines = [ln for ln in proc.stdout.splitlines()
                         if ln.startswith("RESULT ")]
                report[name] = json.loads(lines[-1][7:]) if lines else {
                    "rc": proc.returncode, "stdout": proc.stdout[-3000:],
                    "stderr": proc.stderr[-3000:]}
            except subprocess.TimeoutExpired as exc:
                report[name] = {"timeout": str(exc)[-500:]}
            report[name]["ptxas"] = built
            if report[name].get("passes"):
                passed.append(name)
        print(json.dumps({name: report[name]}, default=str), flush=True)
    if passed:
        report["timing"] = timing(passed, card)
        print(json.dumps({"timing": report["timing"]}, default=str),
              flush=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1, default=str)


if __name__ == "__main__":
    main()
