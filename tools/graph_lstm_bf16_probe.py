"""Holds the graph-form LSTM scans' bf16 kernels (rows 12 and 13 in bf16,
csrc/fused_graph_gru.cu's ``pv2c_graph_lstm_scan_{fwd,bwd}_bf16``) of this
checkout against another commit's on the card: each design is a package
directory (this checkout's, or an earlier commit's unpacked by ``git
archive``), imported under a name of its own so that its wrapper drives its
own library.

For each design, in a process of its own (a fault does not take the
others): the bf16 forward (serving and ``keep``) and the backward (with and
without the cell states' cotangent) at ``chip_smoke.LSTM_BF16_SHAPES``,
ragged B=253 and, forward alone, ``LSTM_BF16_FORWARD_SHAPES``, each output
against the design's own bf16 plain versions (error over max |plain|, bar
``chip_smoke.BF16_BAR``), two calls' bits, and the bf16 forward against the
float32 plain version (how far each design's rounding puts it); the launch
plans. Then, for the designs that pass, in 10 alternating rounds (each
design once a round, the order reversed every other round; CUDA events,
cold L2; medians): rows 12 and 13 in bf16 at GConvLSTM's layer (B=256,
L=16, J=26, H=128, k=2), ragged B=253 and ``chip_smoke.CLS_WIDE`` (J=1,
H=128, k=1; each design beside bf16 cuDNN in ``chip_smoke.paired_ms``
pairs), and the float32 rows 10-13 at GConvLSTM's layer (their bits against
the first design's); row 13 bf16's launches (``chip_smoke.launch_split``);
both bf16 kernels' phases: a ``clock64()`` stamp by thread 0 at each site
of an instrumented copy of the design's source (``PV2C_PHASE``), each
interval's cycles summed over thread blocks by the site that ends it.

    mkdir -p build/parent
    git archive HEAD pedestrians_video_2_carla_torch | tar -x -C build/parent
    python3 tools/graph_lstm_bf16_probe.py OUT.json \\
        parent=build/parent/pedestrians_video_2_carla_torch source

A design is ``source`` (this checkout) or ``NAME=DIR``. Needs one CUDA
card.
"""
import ctypes
import importlib
import json
import os
import re
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
    fused_graph_gru as FG  # noqa: E402

ROOT = Path(os.getcwd()) / "build" / "graph_lstm_probe"
ROUNDS = 10
RAGGED = (253,) + cs.CLS_MAIN[1:]
CHECKED = cs.LSTM_BF16_SHAPES + (RAGGED,)
TIMED = (("main", cs.CLS_MAIN), ("ragged", RAGGED), ("k1", cs.CLS_WIDE))
ROW13_STEPS = ("scan", "dw", "reduce")

# -- the phase split ----------------------------------------------------------

SLOTS = 4096
STAMP = """
__constant__ unsigned long long* g_phase_clk;
// thread 0 of a block: (site + 1, clock64()) into the block's next slot;
// site 0 (a kernel's start) restarts the block's count
__device__ __forceinline__ void pv2c_phase_stamp(int site) {
  __shared__ int phase_n;
  if (threadIdx.x == 0) {
    const long long now = clock64();
    if (site == 0) phase_n = 0;
    if (g_phase_clk != nullptr && phase_n < %d) {
      unsigned long long* p =
          g_phase_clk + 2ull * (blockIdx.x * %dull + phase_n);
      p[0] = site + 1;
      p[1] = now;
    }
    ++phase_n;
  }
}
#define PV2C_PHASE(site) pv2c_phase_stamp(site)
""" % (SLOTS, SLOTS)
SET = """
extern "C" int pv2c_phase_set(unsigned long long* clk) {
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clk, &clk, sizeof(clk)));
}
"""

#: the parent design's sites (the float32 template's kernels on bf16,
#: which have no stamps of their own), by label; an interval is named by
#: the site that ends it
PARENT_LABELS = ("start", "init_loads", "ring_wait", "products", "epilogue",
                 "put_units", "graph", "keep_copy", "gating_wait",
                 "prologue", "setup", "elementwise", "product_wait")
#: where the parent's stamps go: (anchor, the anchor with its stamps), each
#: anchor once in the source
PARENT_EDITS = (
    # block_product: the k-step's loads and ring wait, its products, the
    # epilogue (gating in the forward, P's stores in the backward)
    ("    cp_async_wait<kGStages - 2>();\n    __syncthreads();  // step s "
     "has landed; step s - 1's slot is free\n",
     "    PV2C_PHASE(1);\n    cp_async_wait<kGStages - 2>();\n    "
     "__syncthreads();  // step s has landed; step s - 1's slot is free\n"
     "    PV2C_PHASE(2);\n"),
    ("    if (kstep == ks - 1) {\n",
     "    PV2C_PHASE(3);\n    if (kstep == ks - 1) {\n"),
    ("  }\n}\n\n// The graph matrices in shared memory for the scans",
     "    if (kstep == ks - 1) PV2C_PHASE(4);\n  }\n}\n\n// The graph "
     "matrices in shared memory for the scans"),
    # the forward
    ("  constexpr bool kHShared = V != 1;\n  constexpr bool kBf = IsBf16<St>"
     "::value;\n  extern __shared__ __align__(16) float smem[];\n",
     "  constexpr bool kHShared = V != 1;\n  constexpr bool kBf = IsBf16<St>"
     "::value;\n  extern __shared__ __align__(16) float smem[];\n"
     "  PV2C_PHASE(0);\n"),
    ("  product_prologue<NT, kGates>(ring, slot, w, KH, 4 * H, R, vec);\n"
     "  for (int t = 0; t < L; ++t) {\n",
     "  product_prologue<NT, kGates>(ring, slot, w, KH, 4 * H, R, vec);\n"
     "  PV2C_PHASE(10);\n  for (int t = 0; t < L; ++t) {\n"),
    ("      __syncthreads();\n      graph_product<false, kBf>(S, ld, R, J, H,"
     " k, Tm);\n    }\n    if (KEEP) copy_rows(sa + at * KH, KH, S, ld, R, "
     "KH, vec);\n    block_product<NT, kGates",
     "      __syncthreads();\n      PV2C_PHASE(5);\n      graph_product<false,"
     " kBf>(S, ld, R, J, H, k, Tm);\n      PV2C_PHASE(6);\n    }\n    if "
     "(KEEP) copy_rows(sa + at * KH, KH, S, ld, R, KH, vec);\n    if (KEEP) "
     "PV2C_PHASE(7);\n    block_product<NT, kGates"),
    ("    __syncthreads();  // the carries are complete; S and the ring are "
     "free\n    if (t + 1 < L) product_prologue<NT, kGates>(ring, slot, w, KH,"
     " 4 * H, R, vec);\n",
     "    __syncthreads();  // the carries are complete; S and the ring are "
     "free\n    PV2C_PHASE(8);\n    if (t + 1 < L) product_prologue<NT, "
     "kGates>(ring, slot, w, KH, 4 * H, R, vec);\n    PV2C_PHASE(9);\n"),
    # the backward's reverse scan
    ("  constexpr LstmTiling kT = lstm_tiling(true, V);\n  constexpr int NT = "
     "kT.NT;\n  constexpr bool kBf = IsBf16<St>::value;\n  extern __shared__ "
     "__align__(16) float smem[];\n",
     "  constexpr LstmTiling kT = lstm_tiling(true, V);\n  constexpr int NT = "
     "kT.NT;\n  constexpr bool kBf = IsBf16<St>::value;\n  extern __shared__ "
     "__align__(16) float smem[];\n  PV2C_PHASE(0);\n"),
    ("  product_prologue<NT, kByColumn>(ring, slot, w, 4 * H, KH, R, vec);\n"
     "  for (int t = L - 1; t >= 0; --t) {\n",
     "  product_prologue<NT, kByColumn>(ring, slot, w, 4 * H, KH, R, vec);\n"
     "  PV2C_PHASE(10);\n  for (int t = L - 1; t >= 0; --t) {\n"),
    ("    __syncthreads();\n    block_product<NT, kByColumn, kT.warps_n, "
     "kT.mi>(\n        da, ldd",
     "    __syncthreads();\n    PV2C_PHASE(11);\n    block_product<NT, "
     "kByColumn, kT.warps_n, kT.mi>(\n        da, ldd"),
    ("    __syncthreads();  // P is complete; the ring is free\n    if (t > 0)"
     " {\n      product_prologue<NT, kByColumn>(ring, slot, w, 4 * H, KH, R, "
     "vec);\n      graph_product<true, kBf>(P, ldp, R, J, H, k, Tm);\n    }\n",
     "    __syncthreads();  // P is complete; the ring is free\n    PV2C_PHASE"
     "(12);\n    if (t > 0) {\n      product_prologue<NT, kByColumn>(ring, "
     "slot, w, 4 * H, KH, R, vec);\n      PV2C_PHASE(9);\n      graph_product"
     "<true, kBf>(P, ldp, R, J, H, k, Tm);\n      PV2C_PHASE(6);\n    }\n"),
)


def design_module(name):
    """The design's wrapper module: this checkout's for ``source``, else
    the package of ``NAME=DIR`` copied under build/graph_lstm_probe/NAME as
    ``pv2c_probe_NAME`` and imported so."""
    if name == "source":
        return FG
    label, _, src = name.partition("=")
    pkg = f"pv2c_probe_{label}"
    home = ROOT / label
    if not (home / pkg).exists():
        shutil.copytree(src, home / pkg)
    if str(home) not in sys.path:
        sys.path.insert(0, str(home))
    return importlib.import_module(f"{pkg}.ops.fused_graph_gru")


def instrumented(text):
    """The source with its bf16 LSTM kernels' stamps on, and the labels of
    its sites: a source with stamps of its own (``PV2C_PHASE`` sites named
    by its ``enum LstmPhase``) gets the recording macro; the parent's get
    PARENT_EDITS first."""
    if "PV2C_PHASE" in text:
        body = re.search(r"enum LstmPhase \{([^}]*)\}", text).group(1)
        labels = [re.sub(r"^kPhase", "", n.strip()).lower()
                  for n in body.split(",") if n.strip()]
    else:
        labels = list(PARENT_LABELS)
        for anchor, new in PARENT_EDITS:
            if text.count(anchor) != 1:
                raise AssertionError(f"edit not once: {anchor[:60]!r}")
            text = text.replace(anchor, new)
    head = text.index("#include")
    return text[:head] + "#include <cuda_runtime.h>\n" + STAMP + \
        text[head:] + SET, labels


def split_copy(mod, label):
    text, labels = instrumented(mod._SOURCE.read_text())
    d = ROOT / label.partition("=")[0] / "split"
    d.mkdir(parents=True, exist_ok=True)
    copy = d / mod._SOURCE.name
    copy.write_text(text)
    for header in mod._SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    return copy, labels


def phase_split(mod, label, call, ms):
    """One ``call`` of the design through its instrumented copy: each
    site's cycles (the intervals it ends, summed over thread blocks), its
    share of all, and that share of ``ms``."""
    from pedestrians_video_2_carla_torch.ops import cuda_build
    copy, labels = split_copy(mod, label)
    lib = ctypes.CDLL(str(cuda_build.build_library(copy)))
    for name, argtypes in mod._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
    lib.pv2c_phase_set.argtypes = [ctypes.c_void_p]
    blocks = 1024
    clk = torch.zeros((blocks, SLOTS, 2), dtype=torch.int64, device="cuda")
    cuda_build.check_launch(lib.pv2c_phase_set(clk.data_ptr()), "split")
    keep = mod._library
    mod._library = lambda: lib
    try:
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
    finally:
        mod._library = keep
        lib.pv2c_phase_set(None)
    data = clk.cpu().numpy()
    cycles = [0] * len(labels)
    for b in range(blocks):
        seq = data[b][data[b, :, 0] > 0]
        for (_, c0), (s1, c1) in zip(seq[:-1], seq[1:]):
            if s1 > 1:      # an interval ends at every site but a start
                cycles[s1 - 1] += int(c1 - c0)
    total = max(sum(cycles), 1)
    return {lab: {"cycles": c, "share": c / total, "ms": ms * c / total}
            for lab, c in zip(labels, cycles) if c}


# -- the checks ---------------------------------------------------------------

def err_bits(got, again, ref):
    return [cs.bar_err(got.float(), ref.float())[1], torch.equal(got, again)]


def plans(mod, shape):
    B, _, J, H, k = shape
    out = {"lstm": [mod.graph_lstm_plan(B, J, H, k, b) for b in (0, 1)]}
    if hasattr(mod, "graph_lstm_bf16_plan"):
        out["bf16"] = [mod.graph_lstm_bf16_plan(B, J, H, k, b)
                       for b in (0, 1)]
    return out


def check_case(mod, shape, bwd):
    rng = np.random.default_rng(cs.SEED + 95 + shape[0] + shape[3])
    xg, cheb, (w,), cots = cs.bf16_graph_case(rng, "lstm", shape)
    out = {"plans": plans(mod, shape)}
    with torch.no_grad():
        ys, cst, res = mod.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)
        again = mod.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)
        served = mod.graph_lstm_scan_cuda_fwd(xg, cheb, w)
        ref = mod.graph_lstm_scan_keep_reference(xg, cheb, w)
        for name, a, b, r in zip(("ys", "cs", "gates", "sa"),
                                 (ys, cst, *res), (*again[:2], *again[2]),
                                 (*ref[:2], *ref[2])):
            out[name] = err_bits(a, b, r)
        out["served_same_bits"] = [0.0, torch.equal(served[0], ys)
                                   and torch.equal(served[1], cst)]
        fp32 = FG.graph_lstm_scan_reference(xg.float(), cheb.float(),
                                            w.float())[0]
        out["ys_vs_fp32_plain"] = [cs.bar_err(ys.float(), fp32)[1], True]
        if bwd:
            for tag, dcs in (("", cots[1]), ("_no_dcs", None)):
                got = mod.graph_lstm_scan_cuda_bwd(cheb, w, res, cst, cots[0],
                                                   dcs)
                again = mod.graph_lstm_scan_cuda_bwd(cheb, w, res, cst,
                                                     cots[0], dcs)
                ref = mod.graph_lstm_scan_bwd_reference(cheb, w, res, cst,
                                                        cots[0], dcs)
                for name, a, b, r in zip(("dxg", "dw"), got, again, ref):
                    out[name + tag] = err_bits(a, b, r)
    return out


def check(name):
    """One design's checks, a JSON line on stdout."""
    mod = design_module(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    entry, ok = {}, True
    cases = [(s, True) for s in CHECKED] + [
        (s, False) for s in cs.LSTM_BF16_FORWARD_SHAPES]
    for shape, bwd in cases:
        key = "x".join(map(str, shape))
        try:
            errs = check_case(mod, shape, bwd)
            torch.cuda.synchronize()
        except Exception:  # noqa: BLE001 - a probe reports and goes on
            entry[key] = traceback.format_exc()[-2000:]
            ok = False
            continue
        entry[key] = errs
        ok = ok and all(v[1] and (k.endswith("fp32_plain")
                                  or v[0] <= cs.BF16_BAR)
                        for k, v in errs.items() if k != "plans")
    entry["passes"] = ok
    print("RESULT " + json.dumps(entry, default=str), flush=True)


# -- the timing ---------------------------------------------------------------

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


def lstm_calls(mod, xg, cheb, w, cots):
    """(serve, keep, backward) calls of one design on one case."""
    with torch.no_grad():
        kept = mod.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)

    def serve():
        with torch.no_grad():
            mod.graph_lstm_scan_cuda_fwd(xg, cheb, w)

    def keep():
        with torch.no_grad():
            mod.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)

    def bwd():
        with torch.no_grad():
            mod.graph_lstm_scan_cuda_bwd(cheb, w, kept[2], kept[1], *cots)
    return serve, keep, bwd


def timing(names, card, hbm):
    mods = {n: design_module(n) for n in names}
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush():
        scratch.zero_()
    res = {"card": card, "method": "CUDA events, cold L2 (256 MB write "
           "before each call), %d alternating rounds, medians" % ROUNDS}
    rng = np.random.default_rng(cs.SEED + 96)
    for tag, shape in TIMED:
        xg, cheb, (w,), cots = cs.bf16_graph_case(rng, "lstm", shape)
        calls = {n: lstm_calls(m, xg, cheb, w, cots) for n, m in mods.items()}
        for i, what in enumerate(("row12_bf16", "row12_bf16_keep",
                                  "row13_bf16")):
            res[f"{what}_{tag}"] = rounds({n: c[i] for n, c in calls.items()},
                                          flush)
        res[f"bounds_{tag}"] = {
            "row12_bf16": cs.scan_bound("lstm", shape, hbm, element_size=2,
                                        peak=cs.BF16_PEAK),
            "row12_bf16_keep": cs.scan_bound("lstm", shape, hbm, keep=True,
                                             element_size=2,
                                             peak=cs.BF16_PEAK),
            "row13_bf16": cs.scan_bound("lstm", shape, hbm, True, True,
                                        element_size=2, peak=cs.BF16_PEAK)}
        if tag == "k1":   # bf16 cuDNN computes the same recurrence
            lib_fwd, lib_bwd, err = cs.library_lstm(xg, cheb, w, cots)
            res["cudnn_k1"] = {
                "fwd_ms": cs.cuda_median_ms(lib_fwd, flush=flush),
                "bwd_ms": cs.cuda_median_ms(lib_bwd, flush=flush),
                "vs_plain_over_max": err}
            for n, c in calls.items():
                res.setdefault("paired_vs_cudnn_k1", {})[n] = {
                    "row12_bf16": cs.paired_ms(c[0], lib_fwd, flush),
                    "row13_bf16": cs.paired_ms(c[2], lib_bwd, flush)}
        if tag == "main":
            res["row13_bf16_launch_split"] = {
                n: cs.launch_split(c[2], ROW13_STEPS)
                for n, c in calls.items()}
            for n, m in mods.items():
                res.setdefault("phase_split", {})[n] = {
                    "row12_bf16": phase_split(m, n, calls[n][0],
                                              res["row12_bf16_main"][n]),
                    "row12_bf16_keep": phase_split(
                        m, n, calls[n][1], res["row12_bf16_keep_main"][n]),
                    "row13_bf16_scan": phase_split(
                        m, n, calls[n][2],
                        res["row13_bf16_launch_split"][n]["scan"]["ms"])}
        if tag == "k1":
            for n, m in mods.items():
                res["phase_split"][n]["row12_bf16_k1"] = phase_split(
                    m, n, calls[n][0], res["row12_bf16_k1"][n])
        del calls
    # float32 rows 10-13 at GConvLSTM's layer: times and bits
    first = names[0]
    for cell, rows in (("lstm", ("row12", "row13")),
                       ("gru", ("row10", "row11"))):
        xg, cheb, w, cots = cs.graph_case(rng, cell, cs.CLS_MAIN)
        outs, fns = {}, {}
        for n, m in mods.items():
            with torch.no_grad():
                if cell == "lstm":
                    kept = m.graph_lstm_scan_cuda_fwd(xg, cheb, *w, keep=True)
                    grads = m.graph_lstm_scan_cuda_bwd(cheb, *w, kept[2],
                                                       kept[1], *cots)
                    fns[n] = (lambda m=m: m.graph_lstm_scan_cuda_fwd(
                        xg, cheb, *w),
                        lambda m=m, kept=kept: m.graph_lstm_scan_cuda_bwd(
                            cheb, *w, kept[2], kept[1], *cots))
                    outs[n] = (*kept[:2], *kept[2], *grads)
                else:
                    kept = m.graph_gru_scan_cuda_fwd(xg, cheb, *w, keep=True)
                    grads = m.graph_gru_scan_cuda_bwd(cheb, *w, kept[1],
                                                      cots[0])
                    fns[n] = (lambda m=m: m.graph_gru_scan_cuda_fwd(
                        xg, cheb, *w),
                        lambda m=m, kept=kept: m.graph_gru_scan_cuda_bwd(
                            cheb, *w, kept[1], cots[0]))
                    outs[n] = (kept[0], *kept[1], *grads)
        with torch.no_grad():
            for i, row in enumerate(rows):
                res[row + "_main"] = rounds({n: f[i] for n, f in fns.items()},
                                            flush)
        res[f"{cell}_fp32_same_bits_as_{first}"] = {
            n: all(torch.equal(a, b) for a, b in zip(o, outs[first]))
            for n, o in outs.items()}
        del outs, fns
    return res


def build(name):
    """Builds the design's library and its instrumented copy; the ptxas
    lines of its LSTM kernels, or the error."""
    mod = design_module(name)
    try:
        mod._library()
        from pedestrians_video_2_carla_torch.ops import cuda_build
        cuda_build.build_library(split_copy(mod, name)[0])
        log = Path(str(mod.cuda_build.library_path(mod._SOURCE))).with_suffix(
            ".log")
        lines = log.read_text().splitlines() if log.exists() else []
        return [ln.strip()[:160] for ln in lines
                if ("lstm" in ln and "Compiling entry" in ln)
                or "registers" in ln or "spill" in ln]
    except Exception as exc:  # noqa: BLE001
        return "build error: " + str(exc)[-4000:]


def main():
    if sys.argv[1] == "--check":
        check(sys.argv[2])
        return
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out_path, names = sys.argv[1], sys.argv[2:] or ["source"]
    card, hbm = cs.phase_device()
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
                    capture_output=True, text=True, timeout=900)
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
        report["timing"] = timing(passed, card, hbm)
        print(json.dumps({"timing": report["timing"]}, default=str),
              flush=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1, default=str)


if __name__ == "__main__":
    main()
