"""Export seconds of config 1's serving programs in a process that has
made trainers, with ``torch.utils.tensorboard`` importable or blocked.

Runs ``chip_smoke.py``'s device and build phases and its train-options
and CLI-options phases (their trainers each open a TensorBoard writer
where TensorBoard imports), then exports the LinearAE program of
``chip_smoke.artifact_cases`` three times and its ``fused_train`` program
once, as ``phase_serve_artifacts`` does, and prints one line ``EXP
{...}``: the seconds of each export beside the process's thread, module
and tracked-object counts.

    python3 tools/export_after_trainers.py [normal|notb]

``notb`` blocks ``torch.utils.tensorboard`` before anything imports it.
Run it from the root of a checkout. Needs one CUDA card.
"""
import gc
import os
import sys
import tempfile
import threading
import time

MODE = sys.argv[1] if len(sys.argv) > 1 else "normal"
if MODE == "notb":
    sys.modules["torch.utils.tensorboard"] = None
sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def main():
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.serving import export_inference

    card, _ = cs.phase_device()
    cs.phase_build()
    cs.phase_train_options(card)
    cs.phase_cli_options()
    cases = cs.artifact_cases()
    info = {"exp": MODE, "tree": os.path.basename(os.getcwd()),
            "threads": threading.active_count(),
            "modules": len(sys.modules), "objects": len(gc.get_objects()),
            "tb": sys.modules.get("torch.utils.tensorboard") is not None}
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flow, B, keys, _ in [cases[0], cases[0], cases[0],
                                       cases[2]]:
            inputs, _, meta = next(iter(Carla2D3DDataModule(
                batch_size=B, clip_length=cs.CLIP, seed=cs.SEED,
                test_set_size=B).test_batches()))
            params = flow.init_params()
            t = time.perf_counter()
            export_inference(flow, params, inputs, meta["age_gender_idx"],
                             os.path.join(tmp, "m.pt2"), output_keys=keys)
            times.setdefault(name, []).append(time.perf_counter() - t)
    print("EXP", {**info, "export_s": times}, flush=True)


if __name__ == "__main__":
    main()
