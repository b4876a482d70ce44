"""Run the spatial stack's stand-in build (``build.py``) through the port's
wrapper on CPU tensors, bf16 and float32, against the plain versions: the
serving forward, the training forward's output and residuals
(``spatial_stack_keep_reference``), and the backward from those residuals
against the backward's plain algorithm in float32
(``spatial_stack_bwd_reference``, bar 2^-8 of max |plain| in bf16) and
autograd of the plain version; two backward calls' bits. Prints each
case's errors over max |plain|.

    python tools/cpu_standin/build.py fused_spatial_transformer.cu OUT
    python tools/cpu_standin/spatial.py OUT/fused_spatial_transformer.so \\
        6:26:32:8:64:2 3:32:12:3:864:1

Each case is ``N:J:E:heads:hidden:depth``. PoseFormer's widths at N=6,
depth 2 take about a minute.
"""
import contextlib
import ctypes
import json
import sys
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from pedestrians_video_2_carla_torch.ops import cuda_build  # noqa: E402
from pedestrians_video_2_carla_torch.ops import \
    fused_spatial_transformer as FS  # noqa: E402


def use_standin(so):
    """Point the wrapper at the stand-in library and let it take CPU
    tensors."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in FS._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    FS._library = lambda: lib
    cuda_build.check_cuda_tensors = lambda *a, **k: torch.device("cpu")
    torch.cuda.device = lambda *a, **k: contextlib.nullcontext()
    torch.cuda.current_stream = lambda *a, **k: types.SimpleNamespace(
        cuda_stream=None)
    return lib


def rel(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / max(float(ref.abs().max()),
                                               1e-30))


def weights(rng, E, hidden, depth):
    def w(*shape, scale, shift=0.0):
        return torch.from_numpy((shift + scale * rng.standard_normal(
            shape)).astype(np.float32))
    lead = (depth,)
    return [w(*lead, E, scale=0.2, shift=1.0), w(*lead, E, scale=0.2),
            w(*lead, 3 * E, E, scale=E ** -0.5), w(*lead, 3 * E, scale=0.1),
            w(*lead, E, E, scale=E ** -0.5), w(*lead, E, scale=0.1),
            w(*lead, E, scale=0.2, shift=1.0), w(*lead, E, scale=0.2),
            w(*lead, hidden, E, scale=E ** -0.5),
            w(*lead, hidden, scale=0.1),
            w(*lead, E, hidden, scale=hidden ** -0.5),
            w(*lead, E, scale=0.1),
            w(E, scale=0.2, shift=1.0), w(E, scale=0.2)]


def run(case, dtype):
    N, J, E, H, hidden, depth = case
    rng = np.random.default_rng(7)
    ws = [t.to(dtype) for t in weights(rng, E, hidden, depth)]
    x = torch.from_numpy(rng.standard_normal((N, J, E)).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((N, J, E)).astype(
        np.float32)).to(dtype)
    out = FS.fused_spatial_stack_cuda(x, ws, H)
    out_k, saved = FS.fused_spatial_stack_cuda(x, ws, H, keep=True)
    ref, ref_saved = FS.spatial_stack_keep_reference(x, ws, H)
    res = {"out": rel(out, ref), "keep_same_output": torch.equal(out, out_k)}
    for name, a, b in zip(FS.SAVED, saved, ref_saved):
        res[f"saved_{name}"] = rel(a, b)
    dx, dws = FS.fused_spatial_stack_cuda_bwd(x, ws, saved, g, H)
    dx2, dws2 = FS.fused_spatial_stack_cuda_bwd(x, ws, saved, g, H)
    exact = FS.spatial_stack_bwd_reference(x, ws, saved, g, H)
    plain = FS.plain_backward(FS.spatial_stack_reference, x, ws, g, H)
    res["grads_vs_fp32_algorithm"] = max(
        rel(a, b) for a, b in zip((dx, *dws), (exact[0], *exact[1])))
    res["grads_vs_autograd_of_plain"] = max(
        rel(a, b) for a, b in zip((dx, *dws), (plain[0], *plain[1])))
    res["same_bits_twice"] = all(torch.equal(a, b) for a, b in zip(
        (dx, *dws), (dx2, *dws2)))
    return res


def main():
    use_standin(sys.argv[1])
    for spec in sys.argv[2:]:
        case = tuple(int(v) for v in spec.split(":"))
        for dtype in (torch.bfloat16, torch.float32):
            print(json.dumps({"case": spec, "dtype": str(dtype),
                              **run(case, dtype)}), flush=True)


if __name__ == "__main__":
    main()
