"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device       -- requires CUDA; the card's name and power limit
                     (nvidia-smi).
  2. build        -- builds both kernel libraries with nvcc from this
                     checkout's csrc/ (sm_90a), in parallel; their ptxas
                     summaries.
  3. kernel       -- the serving kernel against its plain PyTorch version on
                     the card, on seeded random rotations: B in {1024, 1000,
                     5} at L=16, and L=1 once. Bounds: 1e-3 px on x and y,
                     1e-4 on depth.
  4. kernel_train -- the training forward kernel against its plain version
                     (1e-3 px, 1e-4 depth, 1e-5 abs_loc) and the backward
                     kernel against autograd of the plain version with
                     seeded cotangents (each gradient over its largest
                     magnitude: rtol 1e-4, atol 1e-5), at B in {1024, 1000,
                     5} with L=16, B=1024 with L=1 and B=5 with L=2; two
                     backward launches give the same bits.
  5. serve        -- the port's serving path at full width: Carla2D3D test
                     batches (B=1024, L=16) -> LinearAE (seeded init) ->
                     PoseLiftingFlow(projection_kernel="fused") ->
                     make_inference_fn, 8 requests; one kernel launch per
                     request; outputs finite and equal to the "plain" flow's;
                     eval_step's loc_2d_3d loss equal to the plain flow's.
  6. train        -- the port's training path at full width: Trainer.fit of
                     PoseLiftingFlow(projection_kernel="fused_train") on
                     Carla2D3D train batches (B=1024, L=16), LinearAE (seeded
                     init), loc_2d_3d, AdamW lr 1e-3: 20 steps and 2
                     validation batches. 22 forward and 20 backward launches;
                     every logged loss finite and the last 5 train losses
                     below the first; metrics.jsonl, best.json and the last
                     checkpoint written, and restoring it gives back the
                     trained params. Then 3 training_steps of the
                     "fused_train" and the "plain" flow from the same params
                     on the same batches: losses equal to rtol 1e-4.
  7. timing       -- CUDA-event medians: the kernels (L2 cold and warm),
                     their plain versions, the eager plane path; host-clock
                     medians: a serving request of both flows, a
                     training_step of both flows, and a standalone call of
                     the plane outputs the "fused_train" step computes (its
                     ratio to the step estimates the plane path's share; it
                     is not measured inside the step).
Then the card line, the kernels line, and the contract line last. Any
failure raises and ends the run with a non-zero exit.
"""
import json
import os
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 22742
BATCH, CLIP = 1024, 16
REQUESTS = 8
TIMING_RUNS = 30
XY_TOL_PX, DEPTH_TOL = 1e-3, 1e-4
LOSS_RTOL = 1e-4
ABS_TOL = 1e-5                          # abs_loc, metres
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5       # gradients over their largest value
TRAIN_STEPS, VAL_BATCHES, PARITY_STEPS = 20, 2, 3
LR = 1e-3
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
    sources = (FP._SOURCE, FP._TRAIN_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        paths = list(pool.map(FP.build_library, sources))
    libraries = {}
    for path in paths:
        log = path.with_suffix(".log")
        log = log.read_text() if log.exists() else ""
        libraries[path.name] = [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln
                                or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": libraries})


def kernel_counts():
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    return {"fused_projection": FP.fused_projection_cuda.launches,
            "fused_projection_train_fwd":
                FP.fused_projection_train_cuda_fwd.launches,
            "fused_projection_train_bwd":
                FP.fused_projection_train_cuda_bwd.launches}


def reset_kernel_counts():
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    for fn in (FP.fused_projection_cuda, FP.fused_projection_train_cuda_fwd,
               FP.fused_projection_train_cuda_bwd):
        fn.launches = 0


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


def scaled_err(got, ref):
    """max |got - ref| / max |ref|, and whether every element is within
    rtol 1e-4 and atol 1e-5 of the reference on that scale."""
    scale = max(float(ref.abs().max()), 1e-8)
    diff = (got - ref).abs() / scale
    ok = bool((diff <= GRAD_ATOL + GRAD_RTOL * ref.abs() / scale).all())
    return float(diff.max()), ok


def phase_kernel_train(camera):
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    from pedestrians_video_2_carla_torch.ops import kinematics as K

    rng = np.random.default_rng(SEED + 1)
    worst_fwd = worst_bwd = 0.0
    for B, L in ((1024, 16), (1000, 16), (5, 16), (BATCH, 1), (5, 2)):
        args = kernel_inputs(rng, B, L, "cuda")
        proj, abs_loc, states = FP.fused_projection_train_cuda_fwd(
            *args, camera)
        inputs = [t.clone().requires_grad_(True) for t in args]
        ref_proj, ref_abs = FP.fused_projection_train_reference(
            *inputs, camera)
        ref = (ref_proj.detach(), ref_abs.detach())
        err_xy = float((proj - ref[0])[..., :2].abs().max())
        err_z = float((proj - ref[0])[..., 2].abs().max())
        err_abs = float((abs_loc - ref[1]).abs().max())
        err_state = float((states.reshape(B, L, 26, 3, 3)
                           - K.accumulate_pose_changes(*args[::2])
                           ).abs().max())

        g_proj, g_abs = (torch.from_numpy(rng.standard_normal(
            (B, L, 26, 3)).astype(np.float32)).cuda() for _ in range(2))
        grads = FP.fused_projection_train_cuda_bwd(
            *args, states, g_proj, g_abs, camera)
        again = FP.fused_projection_train_cuda_bwd(
            *args, states, g_proj, g_abs, camera)
        refs = torch.autograd.grad((ref_proj, ref_abs), inputs,
                                   (g_proj, g_abs))
        torch.cuda.synchronize()
        bwd = {}
        for name, g, r in zip(("pose_changes", "rel_loc", "rel_rot"),
                              grads, refs):
            bwd[name] = scaled_err(g, r) + (float((g - r).abs().max()),)
        same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (proj, abs_loc, states, *grads))
        emit({"phase": "kernel_train", "B": B, "L": L,
              "fwd_max_abs_err_xy_px": err_xy,
              "fwd_max_abs_err_depth": err_z,
              "fwd_max_abs_err_abs_loc": err_abs,
              "fwd_max_abs_err_states": err_state,
              "bwd_max_scaled_err": {k: v[0] for k, v in bwd.items()},
              "bwd_max_abs_err": {k: v[2] for k, v in bwd.items()},
              "bwd_same_bits_twice": same_bits, "finite": finite})
        if not (err_xy <= XY_TOL_PX and err_z <= DEPTH_TOL
                and err_abs <= ABS_TOL and finite):
            raise AssertionError(
                f"training forward kernel disagrees with its plain version "
                f"at B={B}, L={L}: xy {err_xy} px, depth {err_z}, abs_loc "
                f"{err_abs}")
        bad = [k for k, v in bwd.items() if not v[1]]
        if bad or not same_bits:
            raise AssertionError(
                f"training backward kernel at B={B}, L={L}: {bad} outside "
                f"rtol {GRAD_RTOL} / atol {GRAD_ATOL} of autograd of the "
                f"plain version ({bwd}); same bits twice: {same_bits}")
        worst_fwd = max(worst_fwd, err_xy, err_z, err_abs)
        worst_bwd = max([worst_bwd] + [v[2] for v in bwd.values()])
    return worst_fwd, worst_bwd


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

    reset_kernel_counts()
    served = []
    for i, (inputs, _, meta) in enumerate(batches):
        served.append(infer_f(inputs, meta["age_gender_idx"]))
        if FP.fused_projection_cuda.launches != i + 1:
            raise AssertionError(
                f"request {i}: kernel launches "
                f"{FP.fused_projection_cuda.launches}, expected {i + 1}")
    torch.cuda.synchronize()
    counts = kernel_counts()
    launches = counts["fused_projection"]
    if counts["fused_projection_train_fwd"] or \
            counts["fused_projection_train_bwd"]:
        raise AssertionError(f"serving launched a training kernel: {counts}")

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


def make_train_flow(kernel):
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements.linear_ae import \
        LinearAE

    model = LinearAE(generator=torch.Generator().manual_seed(SEED))
    return PoseLiftingFlow(model, loss_modes=["loc_2d_3d"],
                           movements_optimizer=OptimizerSettings(lr=LR),
                           projection_kernel=kernel)


def phase_train(dm):
    """The training path through the port's Trainer, then the per-step
    agreement of the fused_train and plain flows."""
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    flow = make_train_flow("fused_train")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(flow, dm, TrainerConfig(
            max_epochs=1, limit_train_batches=TRAIN_STEPS,
            limit_val_batches=VAL_BATCHES, log_every_n_steps=1, seed=SEED,
            logs_dir=tmp, run_name="smoke"))
        reset_kernel_counts()
        t0 = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = kernel_counts()
        expected = {"fused_projection": 0,
                    "fused_projection_train_fwd": TRAIN_STEPS + VAL_BATCHES,
                    "fused_projection_train_bwd": TRAIN_STEPS}
        if counts != expected:
            raise AssertionError(f"train launches {counts}, expected "
                                 f"{expected}")

        run = os.path.join(tmp, "smoke")
        ckpts = os.path.join(run, "checkpoints")
        for path in (os.path.join(run, "metrics.jsonl"),
                     os.path.join(ckpts, "best.json"),
                     os.path.join(ckpts, "last.pt")):
            if not os.path.exists(path):
                raise AssertionError(f"fit wrote no {path}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = {k: v for r in records for k, v in r.items()
                  if "_loss/" in k and not np.isfinite(v)}
        if losses:
            raise AssertionError(f"non-finite logged losses {losses}")
        steps = [r["train_loss/primary"] for r in records
                 if "lr-movements" in r]
        if len(steps) != TRAIN_STEPS:
            raise AssertionError(f"{len(steps)} step records, expected "
                                 f"{TRAIN_STEPS}")
        if not np.mean(steps[-5:]) < steps[0]:
            raise AssertionError(f"train loss did not fall: {steps}")
        val = records[-1]["val_loss/primary"]

        restored = flow.init_state()
        trainer.checkpoints.restore(restored, os.path.join(ckpts, "last"))
        same = all(torch.equal(restored.params[n][k], v)
                   for n, tree in state.params.items()
                   for k, v in tree.items())
        if not (same and restored.step == state.step == TRAIN_STEPS):
            raise AssertionError("the last checkpoint does not restore the "
                                 "trained params")

    # the fused_train and plain flows, step by step from the same params
    plain = make_train_flow("plain")
    params = flow.init_params()
    states = {"fused_train": flow.init_state(params),
              "plain": plain.init_state(params)}
    stream = dm.train_batches(SEED)
    worst, per_step = 0.0, []
    for _ in range(PARITY_STEPS):
        batch = next(stream)
        _, logs_f = flow.training_step(states["fused_train"], batch)
        _, logs_p = plain.training_step(states["plain"], batch)
        row = {}
        for k in logs_p:
            a, b = float(logs_f[k]), float(logs_p[k])
            rel = abs(a - b) / abs(b)
            if not rel <= LOSS_RTOL:
                raise AssertionError(f"{k}: fused_train {a} vs plain {b}")
            worst = max(worst, rel)
            row[k] = [a, b]
        per_step.append(row)
    emit({"phase": "train", "B": BATCH, "L": CLIP, "steps": TRAIN_STEPS,
          "val_batches": VAL_BATCHES, "launches": counts,
          "fit_seconds": fit_s, "train_loss_primary": steps,
          "val_loss_primary": val, "restored_equal": same,
          "fused_train_vs_plain_losses": per_step,
          "fused_train_vs_plain_max_rel": worst})
    return counts


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


def train_bounds(B, L, J, hbm_rate):
    """The least time of each training kernel at (B, L, J): each input read
    once and each output written once over the memory rate, against its
    float32 operations over the fp32 peak (an FMA counts as 2)."""
    frames, clips = B * L * J, B * J
    fwd_bytes = 4 * (frames * 9 + clips * 3 + clips * 9       # reads
                     + frames * 3 + frames * 3 + frames * 9)  # proj, abs, S
    # per (clip, frame), as the serving kernel: compose J x 27 FMAs, FK
    # (J-1) x 36 FMAs, projection J x (9 FMAs + 10 other operations)
    fwd_flop = B * L * (2 * (J * 27 + (J - 1) * 36 + J * 9) + J * 10)
    bwd_bytes = 4 * (frames * 9 + clips * 3 + clips * 9 + frames * 9
                     + frames * 3 + frames * 3                 # reads
                     + frames * 9 + clips * 3 + clips * 9)     # writes
    # per (clip, frame): FK replay (J-1) x 36 FMAs; projection transpose
    # J x (18 FMAs + 16 other); tree transpose (J-1) x (9 + 27 + 27 FMAs,
    # 9 products, 12 adds into the parent) and 3 adds at the root; the
    # carry J x (9 adds + 27 + 27 FMAs) and d_rel_loc J x 3 adds
    bwd_flop = B * L * (2 * ((J - 1) * 36 + J * 18 + (J - 1) * 63 + J * 54)
                        + J * 16 + (J - 1) * 21 + 3 + J * 12)
    out = {}
    for name, nbytes, nflop in (("fwd", fwd_bytes, fwd_flop),
                                ("bwd", bwd_bytes, bwd_flop)):
        t_bytes, t_flop = nbytes / hbm_rate, nflop / FP32_PEAK
        out[name] = {"bytes": nbytes, "flop": nflop,
                     "bound_ms": max(t_bytes, t_flop) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_flop
                     else "operations"}
    return out


def phase_timing_train(dm, card, hbm_rate):
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    from pedestrians_video_2_carla_torch.ops import kinematics as K
    from pedestrians_video_2_carla_torch.ops.kinematics import (_pack9,
                                                                _unpack9)
    from pedestrians_video_2_carla_torch.ops.projection import \
        projection_state_for

    flow = make_train_flow("fused_train")
    plain = make_train_flow("plain")
    camera = flow.projection.camera
    batch = next(dm.train_batches(SEED + 7))
    inputs, _, meta = batch
    params = flow.init_params()
    with torch.no_grad():
        pose_changes = flow._apply_model(
            flow.movements_model, params["movements"], inputs, None, False)
        state = projection_state_for(meta["age_gender_idx"])
    args = (pose_changes.contiguous(), state.rel_loc, state.rel_rot)
    B, L, J = pose_changes.shape[:3]
    bounds = train_bounds(B, L, J, hbm_rate)
    rng = np.random.default_rng(SEED + 2)
    g_proj, g_abs = (torch.from_numpy(rng.standard_normal(
        (B, L, J, 3)).astype(np.float32)).cuda() for _ in range(2))
    _, _, states = FP.fused_projection_train_cuda_fwd(*args, camera)

    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush_l2():  # 256 MB write: far more than the 50 MB L2
        scratch.zero_()

    def fwd():
        FP.fused_projection_train_cuda_fwd(*args, camera)

    def bwd():
        FP.fused_projection_train_cuda_bwd(*args, states, g_proj, g_abs,
                                           camera)
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    outs = FP.fused_projection_train_reference(*leaves, camera)

    def plain_fwd():
        with torch.no_grad():
            FP.fused_projection_train_reference(*args, camera)

    def plain_bwd():
        torch.autograd.grad(outs, leaves, (g_proj, g_abs), retain_graph=True)

    def plain_fwd_bwd():
        x = [t.detach().requires_grad_(True) for t in args]
        o = FP.fused_projection_train_reference(*x, camera)
        torch.autograd.grad(o, x, (g_proj, g_abs))

    times = {"fwd_ms_cold_l2": cuda_median_ms(fwd, flush=flush_l2),
             "fwd_ms_warm_l2": cuda_median_ms(fwd),
             "bwd_ms_cold_l2": cuda_median_ms(bwd, flush=flush_l2),
             "bwd_ms_warm_l2": cuda_median_ms(bwd),
             "plain_fwd_ms": cuda_median_ms(plain_fwd),
             "plain_bwd_ms": cuda_median_ms(plain_bwd),
             "plain_fwd_bwd_ms": cuda_median_ms(plain_fwd_bwd)}

    def plane_outputs():
        # what the eager "fused_train" projection still computes besides
        # the kernel: the rotation outputs through the plane path, with
        # autograd recording as in a train step
        x = args[0].detach().requires_grad_(True)
        rel9 = K.accumulate9(_unpack9(x), _unpack9(state.rel_rot[:, None]))
        loc = tuple(state.rel_loc[:, None, :, i].expand(B, L, J)
                    for i in range(3))
        abs_loc, abs_rot9 = K.fk_planes(loc, rel9)
        return _pack9(rel9), _pack9(abs_rot9), torch.stack(abs_loc, dim=-1)

    step_states = {"fused_train": flow.init_state(params),
                   "plain": plain.init_state(params)}
    steps = {}
    for name, f in (("fused_train", flow), ("plain", plain)):
        st = step_states[name]
        steps[name] = host_median_ms(lambda: f.training_step(st, batch))
    plane = host_median_ms(plane_outputs)
    emit({"phase": "timing_train", "card": card, "B": B, "L": L, **times,
          "bounds": bounds,
          "train_step_ms_fused_train": steps["fused_train"],
          "train_step_ms_plain": steps["plain"],
          "eager_plane_path_ms_standalone": plane,
          "eager_plane_path_share_estimate": plane / steps["fused_train"],
          "method": "kernels and plain versions: CUDA events, median of %d "
                    "single calls after 3 warm-up calls, cold = 256 MB "
                    "scratch write before each call; train steps and a "
                    "standalone call of the plane path: host clock to "
                    "torch.cuda.synchronize(), median of %d each; the share "
                    "is the ratio of the two medians, an estimate, not a "
                    "measurement inside the step" % (TIMING_RUNS,
                                                     TIMING_RUNS)})
    return {"fwd": {"ms": times["fwd_ms_cold_l2"],
                    "plain_ms": times["plain_fwd_ms"], **bounds["fwd"]},
            "bwd": {"ms": times["bwd_ms_cold_l2"],
                    "plain_ms": times["plain_bwd_ms"], **bounds["bwd"]}}


def kernel_entry(name, source, line, launches, max_err, times):
    return {"name": name, "route": "cuda",
            "source": f"pedestrians_video_2_carla_torch/csrc/{source}",
            "replaces": "pedestrians_video_2_carla_tpu/ops/pallas/"
                        f"fused_projection.py:{line}",
            "launches": launches, "max_abs_err": max_err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
            "library_ms": None}


def main():
    card, hbm_rate = phase_device()
    phase_build()

    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule

    flow_f, flow_p = make_flows()
    max_err = phase_kernel(flow_f.projection.camera)
    err_fwd, err_bwd = phase_kernel_train(flow_f.projection.camera)

    dm = Carla2D3DDataModule(batch_size=BATCH, clip_length=CLIP,
                             test_set_size=REQUESTS * BATCH,
                             val_set_size=VAL_BATCHES * BATCH, seed=SEED)
    batches = list(dm.test_batches())
    params, launches = phase_serve(flow_f, flow_p, batches)
    train_counts = phase_train(dm)
    times = phase_timing(flow_f, flow_p, params, batches, card, hbm_rate)
    train_times = phase_timing_train(dm, card, hbm_rate)

    print(card, flush=True)
    emit({"kernels": [
        kernel_entry("fused_projection", "fused_projection.cu", 328,
                     launches, max_err, times),
        kernel_entry("fused_projection_train_fwd",
                     "fused_projection_train.cu", 458,
                     train_counts["fused_projection_train_fwd"], err_fwd,
                     train_times["fwd"]),
        kernel_entry("fused_projection_train_bwd",
                     "fused_projection_train.cu", 538,
                     train_counts["fused_projection_train_bwd"], err_bwd,
                     train_times["bwd"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
