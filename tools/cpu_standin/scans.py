"""Run the scan kernels' stand-in builds (``build.py``) through the port's
wrappers on CPU tensors, float32 and bf16, against the plain versions: the
training forwards' outputs and residuals, the backwards from them, the
serving forward's bits. Prints each case's error over max |plain|.

    python tools/cpu_standin/scans.py GRU_SO DENSE_SO gru:5:3:26:8:2 \\
        lstm:3:2:26:6:3 dense:5:3:1:3:1

Each case is ``cell:B:L:J:H:k`` (cell gru, lstm (graph form) or dense).
The GRU kernels at B=5, L=3, H=8 take about 10 s.
"""
import contextlib
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from pedestrians_video_2_carla_torch.models.classification.gnn import \
    laplacian_op  # noqa: E402
from pedestrians_video_2_carla_torch.ops import cuda_build  # noqa: E402
from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG  # noqa: E402
from pedestrians_video_2_carla_torch.skeletons.carla import \
    CARLA_SKELETON  # noqa: E402


def load(so, signatures):
    lib = ctypes.CDLL(str(so))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def use_standin(gru_so, dense_so):
    """Point the wrappers at the stand-in libraries and let them take CPU
    tensors."""
    gru, dense = load(gru_so, FG._SIGNATURES), load(dense_so,
                                                   FG._DENSE_SIGNATURES)
    FG._library = lambda: gru
    FG._dense_library = lambda: dense
    FG._scan_plan.cache_clear()
    FG._dense_plan.cache_clear()

    def check(fn_name, dtypes=(torch.float32,), **tensors):
        for name, t in tensors.items():
            assert t.dtype in dtypes and t.is_contiguous(), (fn_name, name)
        return torch.device("cpu")
    cuda_build.check_cuda_tensors = check
    torch.cuda.device = lambda *a, **k: contextlib.nullcontext()
    FG._stream = lambda device: None
    FG._device_index = lambda device: 0


def rel(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / max(float(ref.abs().max()),
                                                1e-12))


def inputs(rng, cell, shape, dtype):
    B, L, J, H, k = shape
    op = laplacian_op(CARLA_SKELETON) if J == 26 else np.zeros((J, J))

    def randn(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(
            np.float32)).to(dtype)
    gates, groups = (3, (2, 1)) if cell == "gru" else (4, (4,))
    return (randn(L, B, J, gates * H),
            torch.from_numpy(FG.cheb_matrices(op, k)).to(dtype),
            [randn(H, k * g * H, scale=H ** -0.5) for g in groups],
            [randn(L, B, J, H) for _ in range(2)])


def run(cell, shape, dtype, rng):
    xg, cheb, ws, cots = inputs(rng, cell, shape, dtype)
    if cell == "gru":
        ys, res = FG.graph_gru_scan_cuda_fwd(xg, cheb, *ws, keep=True)
        ref_ys, ref_res = FG.graph_gru_scan_keep_reference(xg, cheb, *ws)
        out = {"ys": rel(ys, ref_ys), "serving_same": torch.equal(
            ys, FG.graph_gru_scan_cuda_fwd(xg, cheb, *ws))}
        out.update({n: rel(a, b) for n, a, b in zip(res._fields, res,
                                                    ref_res)})
        got = FG.graph_gru_scan_cuda_bwd(cheb, *ws, res, cots[0])
        ref = FG.graph_gru_scan_bwd_reference(cheb, *ws, res, cots[0])
        out.update({n: rel(a, b) for n, a, b in zip(("dxg", "dwzr", "dwh"),
                                                    got, ref)})
        return out
    w = ws[0]
    if cell == "dense":
        kept = FG.dense_lstm_scan_cuda_fwd(xg, w, keep=True)
        ref = FG.dense_lstm_scan_keep_reference(xg, w)
        served = FG.dense_lstm_scan_cuda_fwd(xg, w.t().contiguous().t())
        out = {n: rel(a, b) for n, a, b in zip(("ys", "cs", "gates"), kept,
                                                ref)}
        out["serving_same"] = all(map(torch.equal, served, kept[:2]))
        bwd = lambda dcs: FG.dense_lstm_scan_cuda_bwd(w, kept[2], kept[0],
                                                      kept[1], cots[0], dcs)
        bwd_ref = lambda dcs: FG.dense_lstm_scan_bwd_reference(
            w, kept[2], kept[0], kept[1], cots[0], dcs)
    else:
        ys, cs, res = FG.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)
        ref = FG.graph_lstm_scan_keep_reference(xg, cheb, w)
        out = {n: rel(a, b) for n, a, b in zip(
            ("ys", "cs", "gates", "sa"), (ys, cs, *res), (*ref[:2], *ref[2]))}
        bwd = lambda dcs: FG.graph_lstm_scan_cuda_bwd(cheb, w, res, cs,
                                                      cots[0], dcs)
        bwd_ref = lambda dcs: FG.graph_lstm_scan_bwd_reference(
            cheb, w, res, cs, cots[0], dcs)
    for dcs, tag in ((cots[1], ""), (None, " without dcs")):
        out.update({n + tag: rel(a, b) for n, a, b in zip(
            ("dxg", "dw"), bwd(dcs), bwd_ref(dcs))})
    return out


def main():
    use_standin(sys.argv[1], sys.argv[2])
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        for case in sys.argv[3:]:
            cell, *dims = case.split(":")
            shape = tuple(int(v) for v in dims)
            errs = run(cell, shape, dtype, rng)
            print(str(dtype).split(".")[1], cell, shape,
                  {k: v if isinstance(v, bool) else float(f"{v:.3g}")
                   for k, v in errs.items()}, flush=True)


if __name__ == "__main__":
    main()
