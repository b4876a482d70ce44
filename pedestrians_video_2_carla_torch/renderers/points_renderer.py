"""Skeleton renderer: a circle per joint in the skeleton's colours and a
grey segment per edge, drawn with cv2 on a black canvas. A joint at
(0, 0) is missing and drawn with none of its edges."""
from typing import Iterable, Optional, Tuple, Type

import numpy as np

from ..skeletons.base import Skeleton
from ..skeletons.carla import CARLA_SKELETON
from .renderer import Renderer


class PointsRenderer(Renderer):
    def __init__(self, input_nodes: Type[Skeleton] = CARLA_SKELETON,
                 image_size: Tuple[int, int] = (800, 600), **kwargs):
        super().__init__(image_size=image_size, **kwargs)
        self.nodes = input_nodes
        self._colors = {int(k): v for k, v in input_nodes.get_colors().items()}
        self._edges = [(int(a), int(b)) for a, b in input_nodes.get_edges()]

    def render_frame(self, points: np.ndarray,
                     canvas: Optional[np.ndarray] = None) -> np.ndarray:
        """(J, 2) pixel points -> (H, W, 3) uint8 frame."""
        import cv2

        w, h = self._image_size
        if canvas is None:
            canvas = np.zeros((h, w, 3), dtype=np.uint8)
        pts = np.asarray(points)[..., :2]
        present = np.any(pts != 0, axis=-1)
        for a, b in self._edges:
            if present[a] and present[b]:
                cv2.line(canvas,
                         tuple(np.round(pts[a]).astype(int)),
                         tuple(np.round(pts[b]).astype(int)),
                         (96, 96, 96), 1, lineType=cv2.LINE_AA)
        for j in range(len(pts)):
            if present[j]:
                color = self._colors.get(j, (0, 255, 0, 255))[:3]
                cv2.circle(canvas, tuple(np.round(pts[j]).astype(int)),
                           2, tuple(int(c) for c in color), -1,
                           lineType=cv2.LINE_AA)
        return canvas

    def render_clip(self, clip_points: np.ndarray) -> np.ndarray:
        """(L, J, 2) -> (L, H, W, 3) uint8."""
        return np.stack([self.render_frame(f) for f in clip_points])

    def render(self, frames: np.ndarray, **kwargs) -> Iterable[np.ndarray]:
        """(B, L, J, 2) pixel points -> one clip's frames at a time."""
        for clip in np.asarray(frames):
            yield self.render_clip(clip)
