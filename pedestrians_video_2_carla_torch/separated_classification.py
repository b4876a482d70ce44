"""A/B/C classification comparison (the JAX package's
``separated_classification.py``): train three classifiers, (A) on the raw
noisy data, (B) on an autoencoder's denoised predictions, (C) on clean
data, and report their validation metrics side by side.

    python -m pedestrians_video_2_carla_torch.separated_classification \\
        --data_module_name=Carla2D3D --movements_model_name=LinearAE2D \\
        --classification_model_name=LSTM --noise gaussian --device cpu

``h5py`` and ``yaml`` write the predictions' subsets tree.
"""
import json
import sys
from typing import Dict, List

from .modeling import main as modeling_main


def main(args: List[str]) -> Dict[str, Dict]:
    results: Dict[str, Dict] = {}

    # A: classifier on raw (noisy) data
    a = modeling_main(list(args) + [
        "--flow=classification", "--mode=train", "--renderers", "none",
        "--run_name=cls-raw-noisy"])
    results["raw_noisy"] = a["val_metrics"]

    # B: denoise with the autoencoder, then classify its predictions
    ae = modeling_main(list(args) + [
        "--flow=autoencoder", "--mode=predict",
        "--predict_sets", "train", "val", "test",
        "--renderers", "none", "--run_name=cls-ae"])
    for set_name, outputs in ae["predictions"].items():
        subsets_dir = ae["dm"].save_predictions(set_name, outputs,
                                                run_id="sep")
    b = modeling_main(list(args) + [
        "--flow=classification", "--mode=train",
        f"--subsets_dir={subsets_dir}", "--noise", "zero",
        "--renderers", "none", "--run_name=cls-denoised"])
    results["ae_denoised"] = b["val_metrics"]

    # C: classifier on clean data (noise off)
    c = modeling_main(list(args) + [
        "--flow=classification", "--mode=train", "--noise", "zero",
        "--renderers", "none", "--run_name=cls-clean"])
    results["clean"] = c["val_metrics"]

    print(json.dumps({k: {m: v for m, v in d.items()
                          if isinstance(v, (int, float))}
                      for k, d in results.items()}, indent=1))
    return results


def run():
    main(sys.argv[1:])


if __name__ == "__main__":
    run()
