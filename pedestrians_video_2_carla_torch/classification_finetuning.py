"""Two-stage denoise-then-classify pipeline (the JAX package's
``classification_finetuning.py``): (1) run a pretrained denoising
autoencoder in predict mode over train, val and test and save the
denormalised predictions as a new subsets tree; (2) fine-tune a classifier
on the autoencoder's outputs with input noise off.

    python -m pedestrians_video_2_carla_torch.classification_finetuning \\
        --data_module_name=Carla2D3D --movements_model_name=LinearAE2D \\
        --classification_model_name=LSTM --ckpt_path=... --device cpu

``h5py`` and ``yaml`` write the subsets tree.
"""
import sys
from typing import List

from .modeling import main as modeling_main


def main(args: List[str]):
    # stage 1: predict with the (pretrained) autoencoder over all sets
    results = modeling_main(list(args) + [
        "--flow=autoencoder", "--mode=predict",
        "--predict_sets", "train", "val", "test",
        "--renderers", "none", "--run_name=ae-predict",
    ])
    dm = results["dm"]
    prediction_dirs = {
        set_name: dm.save_predictions(set_name, outputs, run_id="ae")
        for set_name, outputs in results["predictions"].items()}
    subsets_dir = next(iter(prediction_dirs.values()))

    # stage 2: fine-tune the classifier on the denoised data, noise off
    return modeling_main(list(args) + [
        "--flow=classification", "--mode=tune",
        f"--subsets_dir={subsets_dir}",
        "--noise", "zero", "--renderers", "none",
        "--run_name=classifier-finetune",
    ])


def run():
    main(sys.argv[1:])


if __name__ == "__main__":
    run()
