"""Heatmaps: Gaussian rendering of keypoints, argmax decoding and average
pooling to a coarser canvas (the JAX package's ``ops/heatmaps.py``).

Maps are channel-first, ``(..., J(+1), H, W)``; a joint at (0, 0) is
missing and gets an empty map; the optional last channel is the background,
1 - the max over the joints."""
from typing import Tuple

import torch

#: the tail clip of the Gaussian: values below it are 0
TAIL = 0.0099


def gaussian_heatmaps(keypoints: torch.Tensor, image_size: Tuple[int, int],
                      sigma: float = 3.0,
                      add_background: bool = True) -> torch.Tensor:
    """Per-joint Gaussian maps of ``keypoints`` (..., J, 2), pixel (x, y),
    on a canvas of ``image_size`` = (width, height) -> (..., J(+1), H, W),
    on the keypoints' device."""
    w, h = image_size
    device = keypoints.device
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    kx = keypoints[..., 0][..., None, None]
    ky = keypoints[..., 1][..., None, None]
    d2 = (xs - kx) ** 2 + (ys - ky) ** 2
    maps = torch.exp(-d2 / (2.0 * sigma ** 2))
    maps = torch.where(maps < TAIL, torch.zeros_like(maps), maps)
    missing = (keypoints == 0).all(dim=-1)[..., None, None]
    maps = torch.where(missing, torch.zeros_like(maps), maps)
    if add_background:
        bg = 1.0 - maps.amax(dim=-3, keepdim=True)
        maps = torch.cat([maps, bg], dim=-3)
    return maps


def keypoints_from_heatmaps(heatmaps: torch.Tensor,
                            has_background: bool = True) -> torch.Tensor:
    """Argmax decode: (..., J(+1), H, W) -> (..., J, 2) pixel (x, y) of
    each map's first largest value."""
    if has_background:
        heatmaps = heatmaps[..., :-1, :, :]
    h, w = heatmaps.shape[-2:]
    idx = heatmaps.flatten(-2).argmax(dim=-1)
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    return torch.stack([xs, ys], dim=-1)


def downsample_heatmaps(heatmaps: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool maps (..., C, H, W) by ``factor`` in each direction."""
    *lead, c, h, w = heatmaps.shape
    x = heatmaps.reshape(-1, c, h // factor, factor, w // factor, factor)
    return x.mean(dim=(-3, -1)).reshape(*lead, c, h // factor, w // factor)
