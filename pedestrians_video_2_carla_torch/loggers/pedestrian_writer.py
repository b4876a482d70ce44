"""Video writer: predictions denormalized onto the reference skeletons'
screen space, drawn by the chosen renderers, the renderers' clips tiled
into one and written as mp4s with cv2.

The renderers by name: ``zeros`` (black frames), ``input_points`` (the
inputs), ``target_points`` (the target projections), ``projection_points``
(the predicted projections), ``source_videos`` (the source video's
frames, with the ``overlay_*`` drawings) and ``smpl`` (the body mesh of
the targets' ``amass_body_pose``, or the SMPL points of their
projections; ``renderers/smpl_renderer.py``). ``carla`` and
``source_carla`` draw through CARLA's renderer, which is not ported: they
raise ``NotImplementedError``, as any other name raises ``ValueError``."""
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.reference_skeletons import denormalize_from_projection
from ..renderers.points_renderer import PointsRenderer
from ..renderers.renderer import ZerosRenderer
from ..skeletons.carla import CARLA_SKELETON

DEFAULT_RENDERERS = ("input_points", "projection_points")
#: the renderers the writer has
RENDERERS = ("zeros", "input_points", "target_points", "projection_points",
             "source_videos", "smpl")
#: the JAX package's renderers that need CARLA's renderer
UNPORTED_RENDERERS = ("carla", "source_carla")


def check_renderers(names: Iterable[str]) -> List[str]:
    """``names`` without ``none``; raises for a name the writer does not
    render."""
    names = [r for r in names or [] if r and r != "none"]
    for name in names:
        if name in UNPORTED_RENDERERS:
            raise NotImplementedError(
                f"renderer {name!r} needs the CARLA renderer, which is "
                f"not ported to PyTorch yet (ported: "
                f"{list(RENDERERS)}; see ROADMAP.md M8)")
        if name not in RENDERERS:
            raise ValueError(f"unknown renderer {name!r}; one of "
                             f"{list(RENDERERS)} or 'none'")
    return names


class PedestrianWriter:
    def __init__(self, log_dir: str,
                 renderers: Iterable[str] = DEFAULT_RENDERERS,
                 input_nodes=CARLA_SKELETON, output_nodes=CARLA_SKELETON,
                 fps: float = 30.0, max_videos: int = 4,
                 video_saving_frequency_reduction: int = 10,
                 log_every_n_steps: int = 50, merging_method: str = "square",
                 source_videos_dir=None, overlay_skeletons: bool = True,
                 overlay_bboxes: bool = True, overlay_classes: bool = False,
                 **kwargs):
        self.renderers = check_renderers(renderers)
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.fps = fps
        self.max_videos = max_videos
        self.merging_method = merging_method
        #: a training step logs videos every this many steps
        self._throttle = max(1, log_every_n_steps
                             * video_saving_frequency_reduction)
        self.input_nodes = input_nodes
        self.output_nodes = output_nodes
        self.source_videos_dir = source_videos_dir
        self.overlay_skeletons = overlay_skeletons
        self.overlay_bboxes = overlay_bboxes
        self.overlay_classes = overlay_classes
        self._input_renderer = PointsRenderer(input_nodes)
        self._output_renderer = PointsRenderer(output_nodes)
        self._zeros = ZerosRenderer()

    def _denormalize(self, frames: Optional[np.ndarray],
                     age_gender_idx: np.ndarray,
                     normalized: bool) -> Optional[np.ndarray]:
        if frames is None:
            return None
        frames = np.asarray(frames)[..., :2]
        if not normalized:
            return frames
        return denormalize_from_projection(
            torch.as_tensor(frames),
            torch.as_tensor(np.asarray(age_gender_idx))).numpy()

    def _predicted(self, projections, agi):
        """The predicted projections in pixels: the normalized ones
        denormalized, else the pixel ones as they are."""
        return self._denormalize(
            projections.get("projection_2d_transformed",
                            projections.get("projection_2d")),
            agi, normalized="projection_2d_transformed" in projections)

    def _render(self, name: str, inputs, targets, projections, meta,
                normalized: bool):
        agi = meta.get("age_gender_idx",
                       np.zeros(len(inputs), dtype=np.int32))
        if name == "zeros":
            return list(self._zeros.render(frames=inputs))
        if name == "input_points":
            pts = self._denormalize(inputs, agi, normalized)
            return list(self._input_renderer.render(pts))
        if name == "target_points":
            pts = self._denormalize(targets.get("projection_2d"), agi, False)
            return list(self._input_renderer.render(pts)) \
                if pts is not None else list(self._zeros.render(frames=inputs))
        if name == "projection_points":
            pts = self._predicted(projections, agi)
            return list(self._output_renderer.render(pts)) \
                if pts is not None else list(self._zeros.render(frames=inputs))
        if name == "smpl":
            from ..renderers.smpl_renderer import SMPLRenderer
            return list(SMPLRenderer().render(
                amass_body_pose=targets.get("amass_body_pose"),
                projection_2d=targets.get("projection_2d"),
                meta=meta))
        # source_videos
        from ..renderers.source_videos_renderer import SourceVideosRenderer
        rendered = list(SourceVideosRenderer(
            source_videos_dir=self.source_videos_dir,
            input_nodes=self.input_nodes,
            output_nodes=self.output_nodes,
            overlay_skeletons=self.overlay_skeletons,
            overlay_bboxes=self.overlay_bboxes,
            overlay_classes=self.overlay_classes).render(
            meta=meta, targets=targets,
            input_points=targets.get("projection_2d"),
            output_points=self._predicted(projections, agi)))
        if not rendered:
            return list(self._zeros.render(frames=inputs))
        # the video's own size -> the writer's canvas, so that the clips
        # tile
        import cv2
        w, h = self._input_renderer.image_size
        return [np.stack([cv2.resize(f, (w, h)) for f in clip])
                for clip in rendered]

    def _merge(self, videos: List[np.ndarray]) -> np.ndarray:
        """The renderers' clips of one clip, tiled: side by side
        (``horizontal``), stacked (``vertical``) or in a square-ish grid
        padded with black clips (``square``)."""
        if len(videos) == 1:
            return videos[0]
        if self.merging_method == "vertical":
            return np.concatenate(videos, axis=1)
        if self.merging_method == "horizontal":
            return np.concatenate(videos, axis=2)
        n = len(videos)
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        blank = np.zeros_like(videos[0])
        padded = videos + [blank] * (rows * cols - n)
        return np.concatenate([
            np.concatenate(padded[r * cols:(r + 1) * cols], axis=2)
            for r in range(rows)], axis=1)

    def _write_mp4(self, path: str, video: np.ndarray) -> None:
        import cv2
        h, w = video.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 self.fps, (w, h))
        for frame in video:
            writer.write(np.ascontiguousarray(frame[..., ::-1]))  # -> BGR
        writer.release()

    def should_log(self, step: int) -> bool:
        """Whether a training step logs videos: every
        ``log_every_n_steps * video_saving_frequency_reduction`` steps
        (the caller can skip the extra forward pass the videos need)."""
        return bool(self.renderers) and step % self._throttle == 0

    def merged_clips(self, inputs, targets, projections, meta,
                     normalized: bool = True
                     ) -> Tuple[List[np.ndarray], Dict[str, np.ndarray]]:
        """The first ``max_videos`` clips, each the renderers' clips
        tiled: (L, H', W', 3) uint8 arrays; and their ``meta``."""
        sel = slice(0, self.max_videos)
        inputs = np.asarray(inputs)[sel]
        targets = {k: np.asarray(v)[sel] for k, v in targets.items()
                   if hasattr(v, "__len__")}
        projections = {k: np.asarray(v)[sel] for k, v in projections.items()
                       if v is not None and hasattr(v, "__len__")}
        meta = {k: np.asarray(v)[sel] for k, v in meta.items()
                if hasattr(v, "__len__")}
        per_renderer = [self._render(r, inputs, targets, projections, meta,
                                     normalized) for r in self.renderers]
        return [self._merge([pr[i] for pr in per_renderer])
                for i in range(len(inputs))], meta

    def log_videos(self, inputs, targets, projections, meta,
                   step: int = 0, batch_idx: int = 0, stage: str = "train",
                   normalized: bool = True, force: bool = False,
                   vid_callback=None) -> List[str]:
        """Render and write up to ``max_videos`` clips as
        ``{stage}-step=…-batch=…-clip=….mp4``; a step the throttle does
        not admit writes nothing unless ``force``. ``vid_callback(video,
        clip_idx, fps, stage, meta)`` gets each merged clip."""
        if not self.renderers:
            return []
        if not force and step % self._throttle != 0:
            return []
        clips, meta = self.merged_clips(inputs, targets, projections, meta,
                                        normalized)
        paths = []
        for clip_idx, merged in enumerate(clips):
            name = f"{stage}-step={step:0>6d}-batch={batch_idx:0>4d}" \
                   f"-clip={clip_idx:0>2d}.mp4"
            path = os.path.join(self.log_dir, name)
            self._write_mp4(path, merged)
            paths.append(path)
            if vid_callback is not None:
                vid_callback(merged, clip_idx, self.fps, stage, meta)
        return paths
