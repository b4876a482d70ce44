"""MPII Human Pose datamodule: the ``mpii_human_pose_v1_u12_1.mat``
annotations -> single-frame clips (``clip_length`` 1) of the ``single``
or ``multiple`` person variant (``data_variant``), with the head bbox and
the joints' visibility as targets. ``scipy`` and ``pandas`` are imported
only where the annotations are read and split, so this module runs where
pandas is (the CPU host)."""
import os
from typing import Dict, Tuple

import numpy as np

from ...skeletons.mpii import MPII_SKELETON
from ..base.hdf5_datamodule import Hdf5DataModule
from ..base.pandas_mixin import PandasDataModuleMixin

MPII_DIR = "MPII"


class MPIIDataModule(PandasDataModuleMixin, Hdf5DataModule):
    default_data_nodes = MPII_SKELETON
    def __init__(self, data_variant: str = "single",
                 datasets_dir: str = "datasets", **kwargs):
        self.data_variant = data_variant
        self.datasets_dir = datasets_dir
        kwargs.setdefault("data_nodes", MPII_SKELETON)
        kwargs.setdefault("clip_length", 1)
        kwargs.setdefault("clip_offset", 1)
        kwargs.setdefault("test_set_frac", 0)
        super().__init__(
            data_filepath=os.path.join(datasets_dir, MPII_DIR,
                                       "mpii_human_pose_v1_u12_1.mat"),
            video_index=["video"],
            pedestrian_index=["image", "rect_idx"],
            clips_index=["frame_sec"],
            **kwargs)

    @property
    def settings(self):
        return {**super().settings, "data_variant": self.data_variant}

    def _read_data(self):
        import pandas as pd
        from scipy.io import loadmat

        mat = loadmat(self.data_filepath, simplify_cells=True)["RELEASE"]
        anno_list = mat["annolist"]
        video_list = mat["video_list"]
        single_person = mat["single_person"]
        train_mask = mat["img_train"].astype(bool)

        rows = []
        for img_idx, (anno, is_train) in enumerate(zip(anno_list,
                                                       train_mask)):
            if not is_train:
                continue  # MPII has no test ground truth
            rects = anno["annorect"]
            if not isinstance(rects, list):
                rects = [rects]
            if self.data_variant == "single":
                sp = single_person[img_idx]
                indices = [sp - 1] if isinstance(sp, (int, np.integer)) \
                    else [i - 1 for i in np.atleast_1d(sp)]
                if not indices:
                    continue
            else:
                indices = range(len(rects))

            image_name = anno["image"]["name"]
            vididx = anno.get("vididx")
            video_id = video_list[vididx - 1] if vididx else image_name
            frame_sec = anno.get("frame_sec", 0) or 0

            for rect_idx in indices:
                if rect_idx >= len(rects):
                    continue
                rect = rects[rect_idx]
                if not (isinstance(rect, dict) and "annopoints" in rect
                        and isinstance(rect["annopoints"], dict)
                        and "point" in rect["annopoints"]):
                    continue
                points = rect["annopoints"]["point"]
                if not isinstance(points, list):
                    points = [points]
                keypoints = np.zeros((len(MPII_SKELETON), 2), np.float32)
                visibility = [True] * len(MPII_SKELETON)
                for p in points:
                    keypoints[p["id"]] = (p["x"], p["y"])
                    if "is_visible" in p:
                        visibility[p["id"]] = bool(p["is_visible"])
                rows.append({
                    "video": video_id, "image": image_name,
                    "rect_idx": rect_idx, "frame_sec": frame_sec,
                    "head_bbox": (rect.get("x1", 0), rect.get("y1", 0),
                                  rect.get("x2", 0), rect.get("y2", 0)),
                    "keypoints": keypoints,
                    "joints_visibility": tuple(visibility),
                    "scale": rect.get("scale", 1.0),
                })
        df = pd.DataFrame(rows)
        if len(df):
            df.set_index(self.primary_index, inplace=True)
        return df

    def _extract_clips(self, annotations_df):
        """One single-frame clip per annotated person."""
        clips = []
        for i in range(len(annotations_df)):
            clip = annotations_df.iloc[i:i + 1].reset_index().assign(clip=0)
            clips.append(clip)
        return clips

    def _get_raw_data(self, grouped) -> Tuple[np.ndarray, Dict, Dict]:
        projection_2d = self._reshape_to_sequences(grouped, "keypoints")
        head_bbox = np.stack(
            grouped["head_bbox"].apply(list).to_list()).astype(np.float32)
        visibility = np.stack(
            grouped["joints_visibility"].apply(list).to_list())
        targets = {
            "head_bbox": head_bbox.reshape(len(head_bbox), -1, 2, 2),
            "joints_visibility": visibility,
        }
        tail = grouped.tail(1).reset_index(drop=False)
        meta = {
            "video_id": [str(v) for v in tail.loc[:, "video"]],
            "pedestrian_id": [f"{i}_{r}" for i, r in zip(
                tail.loc[:, "image"], tail.loc[:, "rect_idx"])],
            "clip_id": tail.loc[:, "clip"].to_numpy().astype(np.int32),
            "age": ["adult"] * len(tail),
            "gender": ["neutral"] * len(tail),
        }
        return projection_2d, targets, meta
