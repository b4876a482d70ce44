"""Host-side renderers of clips into (L, H, W, 3) uint8 frames for the
video logger (``loggers/``). They draw with cv2, imported only where they
draw."""
from .points_renderer import PointsRenderer
from .renderer import Renderer, ZerosRenderer

__all__ = ["PointsRenderer", "Renderer", "ZerosRenderer"]
