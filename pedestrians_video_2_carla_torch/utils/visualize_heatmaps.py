"""A debugging view of heatmaps: one frame and each of its maps blended
over it in cv2's jet colours, stacked vertically, optionally written to a
PNG (the JAX package's ``utils/visualize_heatmaps.py``). Host numpy and
cv2 only, imported where it draws."""
import os
from typing import Optional

import numpy as np

from ..data.base.video_mixin import IMAGENET_MEAN, IMAGENET_STD


def visualize_heatmaps(clip_frames: np.ndarray,
                       clip_heatmaps: np.ndarray,
                       clip_idx: int = 0,
                       frame_idx: int = 0,
                       output_path: Optional[str] = None) -> np.ndarray:
    """Blend every heatmap channel over the frame, its ImageNet
    normalisation undone.

    :param clip_frames: (B, T, 3, H, W) normalised frames (numpy or a
        tensor).
    :param clip_heatmaps: (B, T, P, h, w) heatmaps; channel 0 goes last in
        the strip.
    :return: the (P + 1) H x W x 3 uint8 strip, also written to
        ``output_path`` where one is given.
    """
    import cv2

    frame = np.asarray(clip_frames)[clip_idx, frame_idx]
    heatmaps = np.asarray(clip_heatmaps)[clip_idx, frame_idx]
    rgb = np.clip((frame.transpose(1, 2, 0) * IMAGENET_STD + IMAGENET_MEAN)
                  * 255.0, 0, 255).astype(np.uint8)
    h, w = rgb.shape[:2]
    images = [rgb]
    for p in list(range(1, heatmaps.shape[0])) + [0]:
        heat = np.clip(heatmaps[p], 0.0, 1.0)
        if heat.shape != (h, w):
            heat = cv2.resize(heat, (w, h))
        colored = cv2.applyColorMap((heat * 255).astype(np.uint8),
                                    cv2.COLORMAP_JET)[..., ::-1]
        images.append((0.2 * rgb + 0.8 * colored).astype(np.uint8))
    strip = np.concatenate(images, axis=0)
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        cv2.imwrite(output_path, strip[..., ::-1])
    return strip
