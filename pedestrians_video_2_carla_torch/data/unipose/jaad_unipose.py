"""JAADUniPose: JAAD's clips with keypoints that the port's UniPoseLSTM
(ResNet-50) extracts from the decoded, bbox-cropped frames instead of the
OpenPose JSONs (the JAX package's ``data/unipose/jaad_unipose.py``,
experimental there too). Without given parameters the model has seeded
random weights; the argmax keypoints go back to frame pixels and are stored
as BODY_25 slots with confidence 1."""
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..base.video_mixin import crop_rect, read_clip_frames, to_model_frames
from ..openpose.datamodules import JAADOpenPoseDataModule

#: the seed of the extracting model's weights when none are given
UNIPOSE_SEED = 0


class JAADUniPoseDataModule(JAADOpenPoseDataModule):
    def __init__(self,
                 unipose_params: Optional[Dict[str, torch.Tensor]] = None,
                 video_size=(256, 256), **kwargs):
        super().__init__(**kwargs)
        self._unipose_params = unipose_params
        self._video_size = tuple(video_size)
        self._model = None

    def _ensure_model(self):
        """The UniPoseLSTM that extracts the keypoints, in evaluation, on
        the data module's device."""
        if self._model is None:
            from ...models.pose_estimation.unipose_lstm import UniPoseLSTM
            model = UniPoseLSTM(
                backbone="resnet50", output_nodes=self.data_nodes,
                generator=torch.Generator().manual_seed(UNIPOSE_SEED))
            if self._unipose_params is not None:
                model.load_state_dict(self._unipose_params)
            self._model = model.to(self.device).eval()
        return self._model

    def _extract_additional_data(self, clips: List):
        from ...ops.heatmaps import keypoints_from_heatmaps

        model = self._ensure_model()
        videos_dir = os.path.join(self.datasets_dir, "JAAD", "videos")
        updated = []
        for clip in clips:
            info = clip.reset_index(drop=True).sort_values("frame")
            video_id = info.iloc[0]["video"]
            start = int(info.iloc[0]["frame"])
            end = int(info.iloc[-1]["frame"]) + 1
            frames = read_clip_frames(
                os.path.join(videos_dir, f"{video_id}.mp4"), start, end)
            if frames is None:
                continue
            bbox = info.iloc[0][["x1", "y1", "x2", "y2"]].to_numpy() \
                .astype(np.float32)
            x1c, y1c, x2c, y2c = crop_rect(frames.shape[1:3], bbox)
            model_in = to_model_frames(frames[:, y1c:y2c, x1c:x2c],
                                       self._video_size)
            x = torch.from_numpy(np.ascontiguousarray(
                model_in.transpose(0, 3, 1, 2)[None])).to(self.device)
            with torch.no_grad():
                heatmaps = model(x)
            kp = keypoints_from_heatmaps(heatmaps)[0].cpu().numpy()
            # heatmap canvas -> crop pixels -> frame pixels, the space of
            # the OpenPose pipeline's keypoints
            hm_h, hm_w = heatmaps.shape[-2:]
            kp = kp * np.asarray([(x2c - x1c) / hm_w, (y2c - y1c) / hm_h],
                                 np.float32) \
                + np.asarray([x1c, y1c], np.float32)
            for i in range(len(info)):
                pts = np.concatenate(
                    [kp[i], np.ones((len(kp[i]), 1), np.float32)], axis=-1)
                info.at[info.index[i], "keypoints"] = pts.tolist()
            updated.append(info)
        return updated
