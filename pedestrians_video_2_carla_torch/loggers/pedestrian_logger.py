"""The trainer's video logger: owns a ``PedestrianWriter``, made at its
first use, under ``save_dir``."""
import os
from typing import Iterable, Optional

from .pedestrian_writer import DEFAULT_RENDERERS, PedestrianWriter


class PedestrianLogger:
    def __init__(self, save_dir: str,
                 renderers: Iterable[str] = DEFAULT_RENDERERS,
                 **kwargs):
        self.save_dir = save_dir
        self.renderers = [r for r in (renderers or []) if r != "none"]
        self._writer: Optional[PedestrianWriter] = None
        self._kwargs = kwargs

    @property
    def experiment(self) -> Optional[PedestrianWriter]:
        if self._writer is None and self.renderers:
            os.makedirs(self.save_dir, exist_ok=True)
            self._writer = PedestrianWriter(
                self.save_dir, renderers=self.renderers, **self._kwargs)
        return self._writer

    def should_log(self, step: int) -> bool:
        writer = self.experiment
        return writer is not None and writer.should_log(step)

    def log_videos(self, **kwargs):
        writer = self.experiment
        if writer is None:
            return []
        return writer.log_videos(**kwargs)
