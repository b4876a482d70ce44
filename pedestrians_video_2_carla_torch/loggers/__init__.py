"""Video logging of clips: render, tile and write mp4s."""
from .pedestrian_logger import PedestrianLogger
from .pedestrian_writer import PedestrianWriter

__all__ = ["PedestrianLogger", "PedestrianWriter"]
