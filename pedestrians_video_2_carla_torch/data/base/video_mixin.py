"""Video inputs: a data module's clips as decoded frames (the JAX package's
``data/base/video_mixin.py``). Each clip's frames are read from its source
video (cv2, imported where it decodes), square-cropped around the clip's
bounding box, resized and ImageNet-normalised on the host; the 2D
keypoints stay as targets, and with ``needs_heatmaps`` their Gaussian maps
on the model's output canvas (``video_size`` / ``heatmaps_stride``), made
on the data module's device, join them. Frames are channel-first: a batch's
inputs are (B, L, 3, H, W)."""
import os
import warnings
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv")


def read_clip_frames(video_path: str, start_frame: int, end_frame: int
                     ) -> Optional[np.ndarray]:
    """Frames [start, end) of a video -> (L, H, W, 3) uint8 RGB; None when
    the video does not open or has fewer frames."""
    import cv2
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return None
    cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
    frames = []
    for _ in range(end_frame - start_frame):
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])  # BGR -> RGB
    cap.release()
    if len(frames) != end_frame - start_frame:
        return None
    return np.stack(frames)


def crop_rect(frame_hw: Tuple[int, int], bbox: np.ndarray,
              margin: float = 0.2) -> Tuple[int, int, int, int]:
    """The square region ``(x1, y1, x2, y2)`` around a clip's bbox points
    (any (..., 2) array of corners), ``margin`` wider, clipped to the
    frame; a region that clips to nothing is the whole frame."""
    h, w = frame_hw
    x1, y1 = bbox.reshape(-1, 2).min(axis=0)
    x2, y2 = bbox.reshape(-1, 2).max(axis=0)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    half = max(x2 - x1, y2 - y1) * (1 + margin) / 2
    x1c = int(max(0, cx - half))
    y1c = int(max(0, cy - half))
    x2c = int(min(w, cx + half))
    y2c = int(min(h, cy + half))
    if x2c <= x1c or y2c <= y1c:
        return 0, 0, w, h
    return x1c, y1c, x2c, y2c


def square_crop(frames: np.ndarray, bbox: np.ndarray,
                margin: float = 0.2) -> np.ndarray:
    """(L, H, W, 3) frames cropped to :func:`crop_rect`."""
    x1c, y1c, x2c, y2c = crop_rect(frames.shape[1:3], bbox, margin)
    return frames[:, y1c:y2c, x1c:x2c]


def to_model_frames(frames: np.ndarray,
                    target_size: Tuple[int, int] = (256, 256)) -> np.ndarray:
    """uint8 (L, H, W, 3) -> ImageNet-normalised float32 (L, th, tw, 3),
    resized by cv2's bilinear."""
    import cv2
    th, tw = target_size
    resized = np.stack([cv2.resize(f, (tw, th)) for f in frames])
    out = resized.astype(np.float32) / 255.0
    return (out - IMAGENET_MEAN) / IMAGENET_STD


class VideoDataModuleMixin:
    """Turns an HDF5 data module's batches into batches of decoded frames
    (before it in the bases). The clips' string metas (``video_id``) ride
    along on the host to find the videos and are dropped before the batch
    is yielded. A video data module streams: its subsets are never kept on
    the device."""

    def __init__(self, source_videos_dir: Optional[str] = None,
                 video_size: Tuple[int, int] = (256, 256),
                 crop_to_bbox: bool = True,
                 needs_heatmaps: bool = False,
                 heatmaps_sigma: float = 3.0,
                 heatmaps_stride: int = 8,
                 **kwargs):
        # the wrapped data module reads source_videos_dir too (CarlaRecorded
        # finds its data.csv there)
        if source_videos_dir is not None:
            kwargs["source_videos_dir"] = source_videos_dir
        super().__init__(**kwargs)
        self.source_videos_dir = source_videos_dir \
            or getattr(self, "source_videos_dir", None)
        self.video_size = tuple(video_size)
        self.crop_to_bbox = crop_to_bbox
        self.needs_heatmaps = needs_heatmaps
        self.heatmaps_sigma = heatmaps_sigma
        self.heatmaps_stride = heatmaps_stride
        self._keep_string_meta = True
        self.device_resident = False

    def _video_path(self, video_id: str) -> str:
        # CarlaRecorded's video ids carry their extension, JAAD's do not
        name = video_id if video_id.lower().endswith(VIDEO_EXTENSIONS) \
            else f"{video_id}.mp4"
        return os.path.join(self.source_videos_dir, name)

    def _clip(self, video_id: Optional[str], start: int, end: int,
              bbox: Optional[np.ndarray]):
        """One clip's model frames (L, th, tw, 3) and the crop's
        (offset, scale) from frame pixels to [0, 1] crop coordinates; None
        where its video does not decode."""
        frames = read_clip_frames(self._video_path(video_id), start, end) \
            if video_id is not None else None
        if frames is None:
            return None
        if self.crop_to_bbox and bbox is not None:
            x1c, y1c, x2c, y2c = crop_rect(frames.shape[1:3], bbox)
            frames = frames[:, y1c:y2c, x1c:x2c]
        else:
            x1c, y1c = 0, 0
            y2c, x2c = frames.shape[1:3]
        return (to_model_frames(frames, self.video_size), (x1c, y1c),
                (1.0 / (x2c - x1c), 1.0 / (y2c - y1c)))

    def _with_video_inputs(self, batches: Iterator) -> Iterator:
        for inputs, targets, meta in batches:
            B = len(inputs)
            video_ids = meta.get("video_id")
            starts = np.asarray(meta["start_frame"].cpu()) \
                if "start_frame" in meta else np.zeros(B, np.int64)
            ends = np.asarray(meta["end_frame"].cpu()) \
                if "end_frame" in meta else np.full(B, self.clip_length)
            bboxes = targets["bboxes"].cpu().numpy() \
                if "bboxes" in targets else None
            clips = []
            for i in range(B):
                video_id = None if video_ids is None else str(video_ids[i])
                clip = self._clip(video_id, int(starts[i]), int(ends[i]),
                                  None if bboxes is None else bboxes[i])
                if clip is None:
                    dropped = "<no video_id in meta>" if video_id is None \
                        else self._video_path(video_id)
                    warnings.warn(
                        f"dropping a whole batch of {B} clips: failed to "
                        f"decode {dropped!r}; check --source_videos_dir")
                    break
                clips.append(clip)
            if len(clips) != B:
                continue
            frames = np.stack([c[0] for c in clips]).transpose(0, 1, 4, 2, 3)
            new_targets = dict(targets)
            if self.needs_heatmaps:
                new_targets["heatmaps"] = self._heatmaps(
                    targets["projection_2d"].cpu().numpy(),
                    np.asarray([c[1] for c in clips], np.float32),
                    np.asarray([c[2] for c in clips], np.float32))
            numeric_meta = {k: v for k, v in meta.items()
                            if isinstance(v, torch.Tensor)}
            yield (torch.from_numpy(np.ascontiguousarray(frames))
                   .to(self.device), new_targets, numeric_meta)

    def _heatmaps(self, keypoints: np.ndarray, offsets: np.ndarray,
                  scales: np.ndarray) -> torch.Tensor:
        """The frame-pixel keypoints (B, L, J, 2+) through each clip's crop
        onto the heatmap canvas, as Gaussian maps with the background."""
        from ...ops.heatmaps import gaussian_heatmaps
        w = self.video_size[1] // self.heatmaps_stride
        h = self.video_size[0] // self.heatmaps_stride
        kp = keypoints[..., :2].astype(np.float32)
        canvas = (kp - offsets[:, None, None, :]) \
            * (scales[:, None, None, :] * np.asarray([w, h], np.float32))
        return gaussian_heatmaps(torch.from_numpy(canvas).to(self.device),
                                 (w, h), self.heatmaps_sigma)

    def train_stream(self, seed: int = 0):
        # whole batches: the decode runs on the trainer's prefetch thread
        return self.train_batches(seed), None

    def train_batches(self, seed: int = 0):
        return self._with_video_inputs(super().train_batches(seed))

    def val_batches(self):
        return self._with_video_inputs(super().val_batches())

    def test_batches(self):
        return self._with_video_inputs(super().test_batches())

    def predict_batches(self, set_name: str):
        return self._with_video_inputs(super().predict_batches(set_name))
