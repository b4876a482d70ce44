"""Missing-joints sensitivity study: the same classifier trained 27 times,
once as the baseline and once with each of the 26 CARLA joints forced
missing (probability 1.0), and each joint's change of the validation
metrics from the baseline's. ``--joints <name> ...`` runs the baseline
and the named joints alone; every other flag goes to the port's CLI.

    python -m pedestrians_video_2_carla_torch.missing_joints_sensitivity \\
        --data_module_name=Carla2D3D --classification_model_name=GConvGRU \\
        --joints crl_hand__L
"""
import json
import sys
from typing import Dict, List

from .modeling import main as modeling_main
from .skeletons.carla import BONE_NAMES, CARLA_SKELETON


def main(args: List[str]) -> Dict[str, Dict[str, float]]:
    num_joints = len(CARLA_SKELETON)
    metrics: Dict[str, Dict[str, float]] = {}

    args = list(args)
    selected = None
    if "--joints" in args:
        at = args.index("--joints")
        selected, rest = [], args[at + 1:]
        while rest and not rest[0].startswith("--"):
            selected.append(rest.pop(0))
        args = args[:at] + rest

    for idx in range(num_joints + 1):
        tag = BONE_NAMES[idx - 1] if idx > 0 else "baseline"
        if selected is not None and idx > 0 and tag not in selected:
            continue
        probs = []
        for j in range(num_joints):
            probs.extend([f"--missing_joint_probabilities_{j}",
                          "1.0" if idx > 0 and j == idx - 1 else "0.0"])
        run_args = args + [
            "--flow=classification", "--mode=train", "--renderers", "none",
            "--noise", "zero", f"--run_name=sensitivity-{tag}",
        ] + probs
        results = modeling_main(run_args)
        metrics[tag] = {k: v for k, v in
                        results.get("val_metrics", {}).items()
                        if isinstance(v, (int, float))}
        print(f"[{tag}] " + json.dumps(metrics[tag]))

    baseline = metrics.get("baseline", {})
    print("\nSensitivity vs baseline (metric deltas):")
    for tag, m in metrics.items():
        if tag == "baseline":
            continue
        deltas = {k: round(m[k] - baseline.get(k, 0.0), 4)
                  for k in m if k.startswith("val_")}
        print(f"  {tag}: {json.dumps(deltas)}")
    return metrics


def run():
    main(sys.argv[1:])


if __name__ == "__main__":
    run()
