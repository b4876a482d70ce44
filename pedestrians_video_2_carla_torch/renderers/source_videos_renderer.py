"""Source-video renderer: each clip's frames of its source video, with the
clip's bounding boxes, the input (red) and predicted (green) skeletons and
the class label drawn on them, each where its switch is on. The clean
``targets['projection_2d']`` is the input skeleton (preprocessing keeps it
un-augmented); the writer hands the predictions already denormalized."""
import os
from typing import Iterable, Optional

import numpy as np

from ..skeletons.carla import CARLA_SKELETON
from .renderer import Renderer

INPUT_COLOR = (255, 0, 0)
OUTPUT_COLOR = (0, 255, 0)
BBOX_COLOR = (255, 255, 0)


class SourceVideosRenderer(Renderer):
    def __init__(self, source_videos_dir: Optional[str] = None,
                 input_nodes=CARLA_SKELETON, output_nodes=None,
                 overlay_skeletons: bool = True,
                 overlay_bboxes: bool = True,
                 overlay_classes: bool = False,
                 class_key: str = "crossing", **kwargs):
        super().__init__(**kwargs)
        self.source_videos_dir = source_videos_dir
        self.input_nodes = input_nodes
        self.output_nodes = output_nodes or input_nodes
        self.overlay_skeletons = overlay_skeletons
        self.overlay_bboxes = overlay_bboxes
        #: write ``{class_key}={label}`` on each frame
        self.overlay_classes = overlay_classes
        self.class_key = class_key

    def _video_path(self, video_id: str) -> str:
        """``{source_videos_dir}/{video_id}``, ``.mp4`` when it has no
        extension."""
        path = os.path.join(self.source_videos_dir or "", f"{video_id}")
        if not os.path.splitext(path)[1]:
            path += ".mp4"
        return path

    def _draw_skeleton(self, frame, points, skeleton, color):
        import cv2
        pts = np.asarray(points)[..., :2]
        present = np.any(pts != 0, axis=-1)
        edges = [(int(a), int(b)) for a, b in skeleton.get_edges()]
        for a, b in edges:
            if present[a] and present[b]:
                cv2.line(frame, tuple(np.round(pts[a]).astype(int)),
                         tuple(np.round(pts[b]).astype(int)),
                         color, 1, lineType=cv2.LINE_AA)
        for j in range(len(pts)):
            if present[j]:
                cv2.circle(frame, tuple(np.round(pts[j]).astype(int)), 2,
                           color, -1, lineType=cv2.LINE_AA)

    def render(self, meta=None, targets=None, input_points=None,
               output_points=None, **kwargs) -> Iterable[np.ndarray]:
        """One clip of frames per ``meta['video_id']``, from
        ``meta['start_frame']`` to ``meta['end_frame']``; black frames for
        a clip whose video does not read. Nothing without video ids or
        ``source_videos_dir``."""
        import cv2

        from ..data.base.video_mixin import read_clip_frames

        meta = meta or {}
        targets = targets or {}
        video_ids = meta.get("video_id")
        if video_ids is None or self.source_videos_dir is None:
            return
        B = len(video_ids)
        starts = np.asarray(meta.get("start_frame", np.zeros(B)), np.int64)
        ends = np.asarray(meta.get("end_frame", starts + 1), np.int64)
        bboxes = np.asarray(targets["bboxes"]) \
            if targets.get("bboxes") is not None else None
        inputs_pts = np.asarray(input_points) \
            if input_points is not None else None
        outputs_pts = np.asarray(output_points) \
            if output_points is not None else None

        for i in range(B):
            try:
                frames = read_clip_frames(
                    self._video_path(str(np.asarray(video_ids[i]))),
                    int(starts[i]), int(ends[i]))
            except Exception:
                frames = None
            if frames is None:
                yield self.zeros(int(ends[i] - starts[i]))
                continue
            frames = np.ascontiguousarray(frames)
            for t, frame in enumerate(frames):
                if self.overlay_bboxes and bboxes is not None:
                    bb = bboxes[i, t].reshape(-1, 2)
                    x0, y0 = bb.min(0)
                    x1, y1 = bb.max(0)
                    if x1 > x0:
                        cv2.rectangle(frame, (int(x0), int(y0)),
                                      (int(x1), int(y1)), BBOX_COLOR, 1)
                if self.overlay_skeletons:
                    if inputs_pts is not None:
                        self._draw_skeleton(frame, inputs_pts[i, t],
                                            self.input_nodes, INPUT_COLOR)
                    if outputs_pts is not None:
                        self._draw_skeleton(frame, outputs_pts[i, t],
                                            self.output_nodes, OUTPUT_COLOR)
                if self.overlay_classes \
                        and targets.get(self.class_key) is not None:
                    label = np.asarray(targets[self.class_key])[i]
                    cv2.putText(frame, f"{self.class_key}={int(label)}",
                                (4, 16), cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                                BBOX_COLOR, 1, lineType=cv2.LINE_AA)
            yield frames
