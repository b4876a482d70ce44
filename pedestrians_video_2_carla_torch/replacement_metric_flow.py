"""Replacement-metric flow (the JAX package's
``replacement_metric_flow.py``), a measure of a dataset's realism: train
model one (an autoencoder) on the source data, predict with it, train model
two on those predictions, then evaluate on the original data. The closer
that evaluation comes to training on the original data directly, the more
"replaceable" the dataset.

    python -m pedestrians_video_2_carla_torch.replacement_metric_flow \\
        --data_module_name=Carla2D3D --movements_model_name=LinearAE2D \\
        --device cpu

``h5py`` and ``yaml`` write the predictions' subsets tree.
"""
import json
import sys
from typing import Dict, List

from .modeling import main as modeling_main


def main(args: List[str]) -> Dict[str, Dict]:
    results: Dict[str, Dict] = {}

    # 1. train model one (an autoencoder) on the source datamodule
    one = modeling_main(list(args) + [
        "--flow=autoencoder", "--mode=train", "--renderers", "none",
        "--run_name=replacement-model-one"])
    results["model_one"] = one["val_metrics"]

    # 2. predict with model one over all sets and save them as a dataset
    pred = modeling_main(list(args) + [
        "--flow=autoencoder", "--mode=predict",
        "--predict_sets", "train", "val", "test",
        "--renderers", "none", "--run_name=replacement-predict"])
    for set_name, outputs in pred["predictions"].items():
        subsets_dir = pred["dm"].save_predictions(set_name, outputs,
                                                  run_id="replacement")

    # 3. train model two on the predictions
    two = modeling_main(list(args) + [
        "--flow=autoencoder", "--mode=train",
        f"--subsets_dir={subsets_dir}", "--renderers", "none",
        "--run_name=replacement-model-two"])
    results["model_two_on_predictions"] = two["val_metrics"]

    # 4. evaluate on the original data
    cross = modeling_main(list(args) + [
        "--flow=autoencoder", "--mode=test", "--renderers", "none",
        "--run_name=replacement-cross-eval"])
    results["cross_eval"] = cross["test_metrics"]

    print(json.dumps({k: {m: v for m, v in d.items()
                          if isinstance(v, (int, float))}
                      for k, d in results.items()}, indent=1))
    return results


def run():
    main(sys.argv[1:])


if __name__ == "__main__":
    run()
