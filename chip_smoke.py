"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  -- requires CUDA; the card's name and power limit (nvidia-smi).
  2. build   -- builds the fused-projection kernel library with nvcc from
                this checkout's csrc/ (sm_90a).
  3. kernel  -- the kernel against its plain PyTorch version on the card, on
                seeded random rotations: B in {1024, 1000, 5} at L=16, and
                L=1 once. Bounds: 1e-3 px on x and y, 1e-4 on depth.
  4. serve   -- the port's serving path at full width: Carla2D3D test
                batches (B=1024, L=16) -> LinearAE (seeded init) ->
                PoseLiftingFlow(projection_kernel="fused") ->
                make_inference_fn, 8 requests; one kernel launch per request;
                outputs finite and equal to the "plain" flow's; eval_step's
                loc_2d_3d loss equal to the plain flow's.
  5. timing  -- CUDA-event medians: kernel, plain version, the eager plane
                path, and the end-to-end request time of both flows.
Then the card line, the kernels line, and the contract line last. Any
failure raises and ends the run with a non-zero exit.
"""
import json
import statistics
import subprocess
import time

import numpy as np
import torch

SEED = 22742
BATCH, CLIP = 1024, 16
REQUESTS = 8
TIMING_RUNS = 30
XY_TOL_PX, DEPTH_TOL = 1e-3, 1e-4
LOSS_RTOL = 1e-4
#: H100 memory rates (NVIDIA data sheets), bytes/s, and the float32 (non
#: tensor-core) peak of the SXM part, FLOP/s
HBM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
FP32_PEAK = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    name = torch.cuda.get_device_name(0)
    rate_key = next((k for k in ("PCIe", "NVL") if k in name), "SXM")
    emit({"phase": "device", "name": name, "card": card,
          "count": torch.cuda.device_count(),
          "hbm_bytes_per_s": HBM_RATE[rate_key], "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return card, HBM_RATE[rate_key]


def phase_build():
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP

    t0 = time.perf_counter()
    path = FP.build_library()
    log = path.with_suffix(".log").read_text() if path.with_suffix(
        ".log").exists() else ""
    emit({"phase": "build", "library": str(path.name),
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})


def random_rotations(rng, shape):
    """Uniform random rotation matrices from normalized gaussian quaternions."""
    q = rng.standard_normal(shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    m = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                 axis=-1)
    return m.reshape(shape + (3, 3)).astype(np.float32)


def kernel_inputs(rng, B, L, device):
    from pedestrians_video_2_carla_torch.ops.projection import \
        projection_state_for

    changes = torch.from_numpy(random_rotations(rng, (B, L, 26))).to(device)
    agi = torch.from_numpy(rng.integers(0, 4, size=B)).to(device)
    state = projection_state_for(agi)
    return changes, state.rel_loc, state.rel_rot


def phase_kernel(camera):
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for B, L in ((1024, 16), (1000, 16), (5, 16), (BATCH, 1)):
        args = kernel_inputs(rng, B, L, "cuda")
        out = FP.fused_projection_cuda(*args, camera)
        ref = FP.fused_projection_reference(*args, camera)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        err_xy = float(err[..., :2].max())
        err_z = float(err[..., 2].max())
        emit({"phase": "kernel", "B": B, "L": L, "max_abs_err_xy_px": err_xy,
              "max_abs_err_depth": err_z, "finite": bool(
                  torch.isfinite(out).all())})
        if not (err_xy <= XY_TOL_PX and err_z <= DEPTH_TOL
                and torch.isfinite(out).all()):
            raise AssertionError(
                f"kernel disagrees with its plain version at B={B}, L={L}: "
                f"xy {err_xy} px, depth {err_z}")
        worst = max(worst, err_xy, err_z)
    return worst


def make_flows():
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.movements.linear_ae import \
        LinearAE

    def flow(kernel):
        model = LinearAE(generator=torch.Generator().manual_seed(SEED))
        return PoseLiftingFlow(model, loss_modes=["loc_2d_3d"],
                               projection_kernel=kernel)
    return flow("fused"), flow("plain")


def phase_serve(flow_f, flow_p, batches):
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    params = flow_f.init_params()
    infer_f = make_inference_fn(flow_f, params)
    infer_p = make_inference_fn(flow_p, params)

    FP.fused_projection_cuda.launches = 0
    served = []
    for i, (inputs, _, meta) in enumerate(batches):
        served.append(infer_f(inputs, meta["age_gender_idx"]))
        if FP.fused_projection_cuda.launches != i + 1:
            raise AssertionError(
                f"request {i}: kernel launches "
                f"{FP.fused_projection_cuda.launches}, expected {i + 1}")
    torch.cuda.synchronize()
    launches = FP.fused_projection_cuda.launches

    worst_xy = worst_z = 0.0
    for preds, (inputs, _, meta) in zip(served, batches):
        for k, v in preds.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"non-finite output {k}")
        ref = infer_p(inputs, meta["age_gender_idx"])
        p, r = preds["projection_2d"], ref["projection_2d"]
        if p.shape != (BATCH, CLIP, 26, 3):
            raise AssertionError(f"projection_2d shape {tuple(p.shape)}")
        worst_xy = max(worst_xy, float((p[..., :2] - r[..., :2]).abs().max()))
        worst_z = max(worst_z, float((p[..., 2] - r[..., 2]).abs().max()))
    if worst_xy > XY_TOL_PX or worst_z > DEPTH_TOL:
        raise AssertionError(f"fused flow vs plain flow: xy {worst_xy} px, "
                             f"depth {worst_z}")

    losses = []
    for batch in batches[:2]:
        lf, _, _ = flow_f.eval_step(params, batch)
        lp, _, _ = flow_p.eval_step(params, batch)
        a, b = float(lf["loc_2d_3d"]), float(lp["loc_2d_3d"])
        if not (np.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b)):
            raise AssertionError(f"loc_2d_3d fused {a} vs plain {b}")
        losses.append((a, b))
    emit({"phase": "serve", "requests": len(batches), "launches": launches,
          "max_abs_err_xy_px_vs_plain": worst_xy,
          "max_abs_err_depth_vs_plain": worst_z,
          "loc_2d_3d_fused_vs_plain": losses})
    return params, launches


def cuda_median_ms(fn, runs=TIMING_RUNS, flush=None):
    """Median over ``runs`` single calls, each between two CUDA events, after
    a warm-up; ``flush`` (if given) runs before each timed call. A ~1 ms
    device sleep ahead of each call keeps the card busy while the host
    enqueues the call, so a call whose launches outrun the host is timed on
    the device alone; a host-bound call still shows its host time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_median_ms(fn, runs=TIMING_RUNS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_timing(flow_f, flow_p, params, batches, card, hbm_rate):
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    from pedestrians_video_2_carla_torch.ops import kinematics as K
    from pedestrians_video_2_carla_torch.ops.kinematics import _unpack9
    from pedestrians_video_2_carla_torch.ops.projection import \
        projection_state_for
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    camera = flow_f.projection.camera
    inputs, _, meta = batches[0]
    with torch.no_grad():
        pose_changes = flow_f._apply_model(
            flow_f.movements_model, params["movements"], inputs, None, False)
        state = projection_state_for(meta["age_gender_idx"])
    args = (pose_changes, state.rel_loc, state.rel_rot)
    B, L, J = pose_changes.shape[:3]

    # the least time: each input read once, the output written once
    nbytes = 4 * (B * L * J * 9 + B * J * 3 + B * J * 9 + B * L * J * 3)
    # per (clip, frame): compose 26 x 27 FMAs, FK 25 x 36 FMAs, projection
    # 26 x (9 FMAs + 3 adds + 1 div + 6 ops); an FMA counts as 2 operations
    nflop = B * L * (2 * (J * 27 + (J - 1) * 36 + J * 9) + J * 10)
    bound_ms = max(nbytes / hbm_rate, nflop / FP32_PEAK) * 1e3
    bound_by = "bytes" if nbytes / hbm_rate >= nflop / FP32_PEAK \
        else "operations"

    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush_l2():  # 256 MB write: far more than the 50 MB L2
        scratch.zero_()

    with torch.no_grad():
        kernel_cold = cuda_median_ms(
            lambda: FP.fused_projection_cuda(*args, camera), flush=flush_l2)
        kernel_warm = cuda_median_ms(
            lambda: FP.fused_projection_cuda(*args, camera))
        plain = cuda_median_ms(
            lambda: FP.fused_projection_reference(*args, camera))

        def plane_path():  # what the eager fused flow still computes
            rel9 = K.accumulate9(_unpack9(pose_changes),
                                 _unpack9(state.rel_rot[:, None]))
            loc = tuple(state.rel_loc[:, None, :, i].expand(B, L, J)
                        for i in range(3))
            K.fk_planes(loc, rel9)
        plane = cuda_median_ms(plane_path)

    infer_f = make_inference_fn(flow_f, params)
    infer_p = make_inference_fn(flow_p, params)
    agi = meta["age_gender_idx"]
    request_fused = host_median_ms(lambda: infer_f(inputs, agi))
    request_plain = host_median_ms(lambda: infer_p(inputs, agi))
    emit({"phase": "timing", "card": card, "B": B, "L": L,
          "kernel_ms_cold_l2": kernel_cold, "kernel_ms_warm_l2": kernel_warm,
          "plain_ms": plain, "bound_us": bound_ms * 1e3,
          "bound_by": bound_by, "bytes": nbytes, "flop": nflop,
          "eager_plane_path_ms": plane,
          "request_ms_fused": request_fused,
          "request_ms_plain": request_plain,
          "method": "CUDA events, median of %d single calls after 3 warm-up "
                    "calls; cold = 256 MB scratch write before each call; "
                    "requests: host clock to torch.cuda.synchronize()"
                    % TIMING_RUNS})
    return {"ms": kernel_cold, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by}


def main():
    card, hbm_rate = phase_device()
    phase_build()

    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule

    flow_f, flow_p = make_flows()
    max_err = phase_kernel(flow_f.projection.camera)

    dm = Carla2D3DDataModule(batch_size=BATCH, clip_length=CLIP,
                             test_set_size=REQUESTS * BATCH, seed=SEED)
    batches = list(dm.test_batches())
    params, launches = phase_serve(flow_f, flow_p, batches)
    times = phase_timing(flow_f, flow_p, params, batches, card, hbm_rate)

    print(card, flush=True)
    emit({"kernels": [{
        "name": "fused_projection",
        "route": "cuda",
        "source": "pedestrians_video_2_carla_torch/csrc/fused_projection.cu",
        "replaces": "pedestrians_video_2_carla_tpu/ops/pallas/"
                    "fused_projection.py:328",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
