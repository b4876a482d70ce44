"""OpenPose datamodules: JAAD / PIE annotation CSVs plus per-frame
OpenPose keypoint JSONs, each frame's candidate matched to the
ground-truth bbox by IoU, the strong-points filter, the JAAD (``beh`` /
``all``) and PIE modules, and the PedestrianActionBenchmark variants (COCO
pose pickles or BODY_25 JSONs). ``pandas`` is imported only where the
annotations are read and split (``..base.pandas_mixin``).
"""
import json
import logging
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...skeletons.openpose import BODY_25_SKELETON, COCO_SKELETON
from ..base.classification_mixin import (BenchmarkDataModuleMixin,
                                         ClassificationDataModuleMixin)
from ..base.hdf5_datamodule import Hdf5DataModule
from ..base.pandas_mixin import PandasDataModuleMixin

OPENPOSE_DIR = "openpose"
JAAD_DIR = "JAAD"
PIE_DIR = "PIE"
JAAD_USECOLS = ["beh", "video", "frame", "x1", "y1", "x2", "y2", "id",
                "gender", "age", "crossing", "crossing_point",
                "video_width", "video_height"]
PIE_USECOLS = ["set_name", "video", "frame", "x1", "y1", "x2", "y2", "id",
               "gender", "age", "crossing", "crossing_point",
               "video_width", "video_height"]


class OpenPoseDataModule(ClassificationDataModuleMixin,
                         PandasDataModuleMixin, Hdf5DataModule):
    default_data_nodes = BODY_25_SKELETON
    def __init__(self,
                 dataset_dirname: str,
                 datasets_dir: str = "datasets",
                 strong_points: float = 0,
                 iou_threshold: float = 0.1,
                 **kwargs):
        self.datasets_dir = datasets_dir
        self.strong_points = strong_points
        self.iou_threshold = iou_threshold
        kwargs.setdefault("data_nodes", BODY_25_SKELETON)
        super().__init__(extra_cols={"keypoints": "object"}, **kwargs)
        self.openpose_dir = os.path.join(datasets_dir, dataset_dirname,
                                         OPENPOSE_DIR)

    @property
    def settings(self):
        return {**super().settings,
                "strong_points": self.strong_points,
                "iou_threshold": self.iou_threshold}

    # -- strong-points filtering ------------------------------------------
    def _is_strong_points(self, clip) -> bool:
        keypoints = np.stack(clip.loc[:, "keypoints"].tolist())
        if self.strong_points < 1.0:
            return bool(np.any(keypoints[..., :2], axis=-1).sum()
                        >= self.strong_points
                        * np.prod(keypoints.shape[:-1]))
        return bool(np.all(np.any(keypoints[..., :2], axis=-1)))

    def _clean_filter_sort_clips(self, clips):
        if self.strong_points:
            return [c for c in clips if self._is_strong_points(c)]
        return clips

    # -- keypoint extraction ----------------------------------------------
    def _extract_additional_data(self, clips: List):
        updated = []
        for clip in clips:
            info = clip.reset_index(drop=True).sort_values("frame")
            set_name = info.iloc[0]["set_name"] \
                if "set_name" in info.columns else ""
            video_id = info.iloc[0]["video"]
            start = int(info.iloc[0]["frame"])
            stop = int(info.iloc[-1]["frame"]) + 1

            root = os.path.join(self.openpose_dir, set_name, video_id)
            if not os.path.exists(root):
                logging.getLogger(__name__).warning(
                    "Keypoints dir not found: %s", root)
                continue

            ok = True
            for i, f in enumerate(range(start, stop)):
                path = os.path.join(
                    root, "{:s}_{:0>12d}_keypoints.json".format(video_id, f))
                if not os.path.exists(path):
                    logging.getLogger(__name__).warning(
                        "Keypoints file not found: %s", path)
                    ok = False
                    break
                gt_bbox = info.iloc[i][["x1", "y1", "x2", "y2"]] \
                    .to_numpy().reshape(2, 2).astype(np.float32)
                with open(path) as jp:
                    people = json.load(jp)["people"]
                if not people:
                    info.at[info.index[i], "keypoints"] = np.zeros(
                        (len(self.data_nodes), 3)).tolist()
                else:
                    candidates = [np.array(p["pose_keypoints_2d"])
                                  .reshape(-1, 3) for p in people]
                    info.at[info.index[i], "keypoints"] = \
                        self._select_best_candidate(candidates,
                                                    gt_bbox).tolist()
            if ok:
                updated.append(info)
        return updated

    def _select_best_candidate(self, candidates: List[np.ndarray],
                               gt_bbox: np.ndarray) -> np.ndarray:
        """The candidate of largest IoU with the ground-truth bbox; all
        zeros when that IoU is below the threshold."""
        boxes = []
        for c in candidates:
            detected = c[np.any(c[:, 0:2], axis=1), 0:2]
            if not len(detected):
                boxes.append(np.zeros((2, 2), np.float32))
            else:
                boxes.append(np.stack([detected.min(0), detected.max(0)]))
        boxes = np.asarray(boxes)

        gt_min, gt_max = gt_bbox.min(0), gt_bbox.max(0)
        c_min, c_max = boxes.min(1), boxes.max(1)
        inter_min = np.maximum(gt_min, c_min)
        inter_max = np.minimum(gt_max, c_max)
        inter = np.clip((inter_max - inter_min + 1), 0, None).prod(1)
        gt_area = (gt_max - gt_min + 1).prod()
        c_area = (c_max - c_min + 1).prod(1)
        iou = inter / (gt_area + c_area - inter)
        best = int(np.argmax(iou))
        if iou[best] < self.iou_threshold:
            return np.zeros((len(self.data_nodes), 3))
        return candidates[best]

    # -- raw data assembly -------------------------------------------------
    def _get_raw_data(self, grouped) -> Tuple[np.ndarray, Dict, Dict]:
        projection_2d = self._reshape_to_sequences(grouped, "keypoints")
        bboxes = np.stack([
            self._reshape_to_sequences(grouped, "x1"),
            self._reshape_to_sequences(grouped, "y1"),
            self._reshape_to_sequences(grouped, "x2"),
            self._reshape_to_sequences(grouped, "y2"),
        ], axis=-1).astype(np.float32)
        targets = {"bboxes": bboxes.reshape(*bboxes.shape[:-1], 2, 2)}
        meta, *_ = self._get_raw_meta(grouped)
        return projection_2d, targets, meta

    def _get_raw_meta(self, grouped):
        head = grouped.head(1).reset_index(drop=False)
        tail = grouped.tail(1).reset_index(drop=False)
        meta = {
            "set_name": tail.loc[:, "set_name"].to_list()
            if "set_name" in tail.columns else [""] * len(tail),
            "video_id": tail.loc[:, "video"].to_list(),
            "pedestrian_id": tail.loc[:, "id"].to_list(),
            "clip_id": tail.loc[:, "clip"].to_numpy().astype(np.int32),
            "age": tail.loc[:, "age"].to_list(),
            "gender": tail.loc[:, "gender"].to_list(),
            "start_frame": head.loc[:, "frame"].to_numpy().astype(np.int32),
            "end_frame": tail.loc[:, "frame"].to_numpy().astype(np.int32) + 1,
            "clip_width": tail.loc[:, "video_width"].to_numpy()
            .astype(np.int32),
            "clip_height": tail.loc[:, "video_height"].to_numpy()
            .astype(np.int32),
        }
        self._add_classification_to_meta(grouped, tail, meta)
        return meta, head, tail


def _cross_converter_factory(num_classes: int):
    if num_classes == 2:
        return lambda x: x == "1"
    return lambda x: int(x) % num_classes


class JAADOpenPoseDataModule(OpenPoseDataModule):
    def __init__(self, sample_type: str = "beh",
                 datasets_dir: str = "datasets", **kwargs):
        self.sample_type = sample_type
        conv = _cross_converter_factory(kwargs.get("num_classes", 2))
        kwargs.setdefault("classification_targets_key", "crossing")
        super().__init__(
            dataset_dirname=JAAD_DIR,
            datasets_dir=datasets_dir,
            data_filepath=os.path.join(datasets_dir, JAAD_DIR,
                                       "annotations.csv"),
            video_index=["video"], pedestrian_index=["id"],
            clips_index=["clip", "frame"],
            df_usecols=JAAD_USECOLS,
            df_filters={"beh": [True]} if sample_type == "beh" else None,
            converters={"crossing": conv, "beh": lambda x: x == "True"},
            **kwargs)

    @property
    def settings(self):
        return {**super().settings, "sample_type": self.sample_type}


class PIEOpenPoseDataModule(OpenPoseDataModule):
    def __init__(self, datasets_dir: str = "datasets", **kwargs):
        conv = _cross_converter_factory(kwargs.get("num_classes", 2))
        kwargs.setdefault("classification_targets_key", "crossing")
        super().__init__(
            dataset_dirname=PIE_DIR,
            datasets_dir=datasets_dir,
            data_filepath=os.path.join(datasets_dir, PIE_DIR,
                                       "annotations.csv"),
            video_index=["set_name", "video"], pedestrian_index=["id"],
            clips_index=["clip", "frame"],
            df_usecols=PIE_USECOLS,
            converters={"crossing": conv},
            **kwargs)


class _YorkUBenchmarkMixin(BenchmarkDataModuleMixin):
    """Benchmark variants support COCO pose pickles from
    PedestrianActionBenchmark in addition to BODY_25 OpenPose JSONs."""

    def __init__(self, pose_pickles_dir: Optional[str] = None,
                 pose_data: str = "json", **kwargs):
        self.pose_data = pose_data
        kwargs["data_nodes"] = COCO_SKELETON if pose_data == "pickle" \
            else BODY_25_SKELETON
        super().__init__(**kwargs)
        self._pose_pickles_dir = os.path.join(
            self.datasets_dir, pose_pickles_dir) if pose_pickles_dir else None

    @property
    def settings(self):
        return {**super().settings, "pose_data": self.pose_data}

    def _extract_additional_data(self, clips):
        if self.pose_data != "pickle":
            return super()._extract_additional_data(clips)
        # poses from the benchmark-provided pickles, keyed by set/video/ped/frame
        pose_data: Dict[str, Any] = {}
        for file in os.listdir(self._pose_pickles_dir):
            with open(os.path.join(self._pose_pickles_dir, file), "rb") as f:
                set_name = os.path.splitext(file)[0].split("_")[1]
                try:
                    pose_data[set_name] = pickle.load(f)
                except Exception:
                    continue
        updated = []
        for clip in clips:
            info = clip.reset_index(drop=True).sort_values("frame")
            set_name = info.iloc[0].get("set_name", "") or \
                next(iter(pose_data.keys()), "")
            video_id = info.iloc[0]["video"]
            ped_id = info.iloc[0]["id"]
            try:
                video_poses = pose_data[set_name][video_id][ped_id]
            except KeyError:
                continue
            ok = True
            for i, f in enumerate(info["frame"]):
                key = f"{int(f):05d}"
                if key not in video_poses:
                    ok = False
                    break
                kp = np.asarray(video_poses[key], dtype=np.float32) \
                    .reshape(-1, 2)
                kp = np.concatenate(
                    [kp, np.ones((len(kp), 1), np.float32)], axis=-1)
                info.at[info.index[i], "keypoints"] = kp.tolist()
            if ok:
                updated.append(info)
        return updated


class JAADBenchmarkDataModule(_YorkUBenchmarkMixin, JAADOpenPoseDataModule):
    def __init__(self, **kwargs):
        kwargs.setdefault("sample_type", "beh")
        super().__init__(**kwargs)


class PIEBenchmarkDataModule(_YorkUBenchmarkMixin, PIEOpenPoseDataModule):
    pass
