"""Pose-estimation flow (the JAX package's ``flows/pose_estimation.py``):
the model predicts the 2D keypoints of clips of frames (B, L, 3, H, W),
directly or as heatmaps decoded by their argmax; the metrics are the
autoencoder flow's."""
import torch

from ..ops import normalization as N
from ..ops.heatmaps import keypoints_from_heatmaps
from .autoencoder import AutoencoderFlow
from .output_types import PoseEstimationModelOutputType


class PoseEstimationFlow(AutoencoderFlow):
    def initial_preds(self, inputs, targets):
        """No inputs-as-predictions baseline on frames: the inputs are
        not keypoints."""
        if inputs.ndim == 5:
            return {}
        return super().initial_preds(inputs, targets)

    def _inner_step(self, params, batch, training):
        inputs, targets, meta = batch
        model = self.movements_model
        out = self._apply_model(
            model, params["movements"], inputs,
            targets if training and model.needs_targets else None, training)
        es = (slice(None), model.eval_slice)
        sliced = {"inputs": inputs[es],
                  "targets": {k: v[es] if hasattr(v, "ndim") and v.ndim > 1
                              else v for k, v in targets.items()}}
        if model.output_type != PoseEstimationModelOutputType.heatmaps:
            sliced[self.outputs_key] = out[es]
            return sliced
        sliced["heatmaps"] = out[es]
        # the argmax lives on the heatmap canvas: scaled to the input
        # frame's pixels, then normalised as the targets are (the
        # hips-neck transform reads the keypoints alone)
        H, W = inputs.shape[-2:]
        hm_h, hm_w = out.shape[-2:]
        kp = keypoints_from_heatmaps(out) * torch.tensor(
            [W / hm_w, H / hm_h], dtype=torch.float32, device=out.device)
        sliced["projection_2d"] = kp[es]
        if self.transform not in (None, "none"):
            kp_t, _ = N.normalize_with(kp, model.output_nodes,
                                       extractor=self.transform)
            sliced["projection_2d_transformed"] = kp_t[es]
        return sliced
