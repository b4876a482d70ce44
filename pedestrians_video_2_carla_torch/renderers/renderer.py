"""Renderer base: per-clip data -> (L, H, W, 3) uint8 frame stacks."""
from typing import Iterable, Tuple

import numpy as np


class Renderer:
    def __init__(self, image_size: Tuple[int, int] = (800, 600), **kwargs):
        self._image_size = image_size

    @property
    def image_size(self) -> Tuple[int, int]:
        """(width, height) of a frame."""
        return self._image_size

    def render(self, **kwargs) -> Iterable[np.ndarray]:
        """Yield one (L, H, W, 3) uint8 array per clip."""
        raise NotImplementedError

    def zeros(self, clip_length: int) -> np.ndarray:
        w, h = self._image_size
        return np.zeros((clip_length, h, w, 3), dtype=np.uint8)


class ZerosRenderer(Renderer):
    """Black frames, one clip per clip of ``frames`` (B, L, ...)."""

    def render(self, frames=None, meta=None, **kwargs):
        for _ in range(len(frames)):
            yield self.zeros(frames.shape[1])
