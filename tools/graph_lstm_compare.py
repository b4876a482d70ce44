"""Times the graph-form LSTM scan kernels of one or more checkouts on the
card, in turns within one process: at GConvLSTM's layer (B=256, L=16,
J=26, H=128, k=2) and at k = 1 past the dense kernels' width (B=256, L=16,
J=1, H=128) against torch.nn.LSTM (cuDNN, alone, in alternating pairs, and
its identity input products alone), one HoistedLSTM(kernel="fused") layer
at hidden 128 against torch.nn.LSTM, and GConvLSTM's training_step and
eval_step fused and plain. Each checkout's own chip_smoke.py provides the
timing functions, so an older commit is timed as it was.

    python3 tools/graph_lstm_compare.py OUT.json TAG=CHECKOUT [TAG=CHECKOUT ...]

e.g. a parent commit unpacked by ``git archive`` into ``build/parent``
against this tree, in the order parent, this, this, parent:

    python3 tools/graph_lstm_compare.py build/compare.json \\
        parent=build/parent this=. this2=. parent2=build/parent

Each checkout builds its kernels into its own build/torch_kernels/. Needs
one CUDA card; writes OUT.json and prints one JSON line per checkout.
"""
import importlib
import inspect
import json
import os
import sys

import numpy as np
import torch

K1 = (256, 16, 1, 128, 1)
LAYER_INPUTS = (52, 128)


def load_tree(path):
    """The checkout's chip_smoke and fused_graph_gru modules (the package
    and chip_smoke of the previous checkout unloaded first)."""
    for name in list(sys.modules):
        if name == "chip_smoke" or name.startswith(
                "pedestrians_video_2_carla_torch"):
            del sys.modules[name]
    sys.path.insert(0, os.path.abspath(path))
    try:
        cs = importlib.import_module("chip_smoke")
        fg = importlib.import_module(
            "pedestrians_video_2_carla_torch.ops.fused_graph_gru")
    finally:
        sys.path.pop(0)
    return cs, fg


def measure(path):
    cwd = os.getcwd()
    os.chdir(path)      # the checkout's build/ and csrc/
    try:
        cs, fg = load_tree(".")
        return run(cs, fg)
    finally:
        os.chdir(cwd)


def run(cs, fg):
    card, hbm = cs.phase_device()
    cs.phase_build()
    rng = np.random.default_rng(cs.SEED + 13)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    out = {"card": card, "main": cs.time_scan("lstm", cs.CLS_MAIN, flush, hbm,
                                              rng)}
    xg, cheb, (w,), cots = cs.graph_case(rng, "lstm", K1)
    lib_fwd, lib_bwd, err = cs.library_lstm(xg, cheb, w, cots)
    kept = "res" in inspect.signature(fg.graph_lstm_scan_cuda_bwd).parameters
    with torch.no_grad():
        if kept:
            _, c_s, res = fg.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)
        else:
            ys, c_s = fg.graph_lstm_scan_cuda_fwd(xg, cheb, w)

    def fwd():
        fg.graph_lstm_scan_cuda_fwd(xg, cheb, w)

    def bwd():
        if kept:
            fg.graph_lstm_scan_cuda_bwd(cheb, w, res, c_s, *cots)
        else:
            fg.graph_lstm_scan_cuda_bwd(xg, cheb, w, ys, c_s, *cots)
    a = xg.reshape(-1, 4 * K1[3])
    eye = torch.eye(4 * K1[3], device=a.device)
    out["k1"] = {
        "fwd_ms": cs.cuda_median_ms(fwd, flush=flush),
        "bwd_ms": cs.cuda_median_ms(bwd, flush=flush),
        "library_fwd_ms": cs.cuda_median_ms(lib_fwd, flush=flush),
        "library_bwd_ms": cs.cuda_median_ms(lib_bwd, flush=flush),
        "identity_fwd_ms": cs.cuda_median_ms(lambda: torch.mm(a, eye),
                                             flush=flush),
        "identity_bwd_ms": cs.cuda_median_ms(
            lambda: (torch.mm(a, eye), torch.mm(a.t(), a)), flush=flush),
        "fwd_pairs": cs.paired_ms(fwd, lib_fwd, flush),
        "bwd_pairs": cs.paired_ms(bwd, lib_bwd, flush),
        "library_err": err}
    if hasattr(cs, "time_lstm_layers"):
        out["layers_h128"] = cs.time_lstm_layers(K1, LAYER_INPUTS, flush, rng)
    else:           # an older chip_smoke: its layer timing reads CLS_DENSE
        cs.CLS_DENSE, cs.DENSE_LAYER_INPUTS = K1, LAYER_INPUTS
        out["layers_h128"] = cs.time_dense_lstm_layers(flush, rng)
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    dm = Carla2D3DDataModule(batch_size=cs.CLS_BATCH, clip_length=cs.CLIP,
                             seed=cs.SEED)
    batch = next(dm.train_batches(cs.SEED + 7))
    steps = {}
    for route in ("fused", "plain"):
        flow = cs.make_cls_flow("GConvLSTM", graph_kernel=route)
        state, params = flow.init_state(), flow.init_params()
        steps[route] = {
            "train_step_ms_host": cs.host_median_ms(
                lambda: flow.training_step(state, batch)),
            "eval_step_ms_host": cs.host_median_ms(
                lambda: flow.eval_step(params, batch))}
    out["gconv_lstm_steps"] = steps
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dest, trees = sys.argv[1], [a.split("=", 1) for a in sys.argv[2:]]
    results = {}
    for tag, path in trees:
        results[tag] = measure(path)
        print(json.dumps({"tag": tag, **results[tag]}), flush=True)
    with open(dest, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
