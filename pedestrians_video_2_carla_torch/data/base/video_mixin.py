"""Reading clips of the source videos (cv2, imported where it reads). The
video data modules and their crops come with pose estimation."""
from typing import Optional

import numpy as np


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
