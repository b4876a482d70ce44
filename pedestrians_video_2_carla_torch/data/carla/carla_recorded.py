"""CARLA-BSP recorded clips: a ``data.csv`` with stringified per-frame
lists (the camera's transform, the pedestrian's transform and velocity, its
pose in world, component, relative and camera space), parsed, windowed
into clips, kept where the pedestrian is in frame in every frame, with
bboxes and the pose's locations and rotations as targets (the last three
columns of a transform are euler degrees, turned into "XYZ" matrices
without the CARLA -> PyTorch3D negation, as in the JAX package).
``CarlaBenchmarkDataModule`` adds each video's ``crossing_point`` and
``crossing``. ``pandas`` is imported only where the CSV is read and the
clips are split.

:func:`recorded_subset` builds a subset in memory with the fields, shapes
and dtypes a prepared subset has, for ``Hdf5DataModule.add_subset`` on a
machine that cannot parse the CSV.
"""
import ast
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ...ops.rotations import euler_angles_to_matrix_np
from ...skeletons.carla import CARLA_SKELETON
from ..base.classification_mixin import (BenchmarkDataModuleMixin,
                                         ClassificationDataModuleMixin)
from ..base.hdf5_datamodule import Hdf5DataModule
from ..base.pandas_mixin import PandasDataModuleMixin

CARLA_RECORDED_DEFAULT_SET_NAME = "default"
#: the classification label of the recorded clips
CROSSING_KEY = "frame.pedestrian.is_crossing"
LABELS = ("not-crossing", "crossing")


def convert_to_list(x):
    """A CSV cell's stringified list (``nan`` allowed) -> the list; a cell
    that is no literal stays a string."""
    try:
        return ast.literal_eval(x.replace("nan", '"nan"'))
    except ValueError:
        return str(x)


def _np_bboxes(projection_2d: np.ndarray, near_zero=1e-5) -> np.ndarray:
    """(..., J, C) points -> (..., 2, C) per-frame (min, max) over the
    joints, ignoring the missing ones."""
    missing = np.all(projection_2d[..., :2] < near_zero, axis=-1,
                     keepdims=True)
    mins = np.min(np.where(missing, np.inf, projection_2d), axis=-2)
    maxs = np.max(np.where(missing, -np.inf, projection_2d), axis=-2)
    return np.stack([mins, maxs], axis=-2).astype(np.float32)


class CarlaRecordedDataModule(ClassificationDataModuleMixin,
                              PandasDataModuleMixin, Hdf5DataModule):
    default_data_nodes = CARLA_SKELETON

    def __init__(self,
                 data_variant: str = CARLA_RECORDED_DEFAULT_SET_NAME,
                 source_videos_dir: str = None,
                 datasets_dir: str = "datasets/CARLA",
                 **kwargs):
        self.data_variant = data_variant
        source_videos_dir = source_videos_dir or os.path.join(
            datasets_dir, data_variant)
        kwargs.setdefault("classification_targets_key", CROSSING_KEY)
        kwargs.setdefault("data_nodes", CARLA_SKELETON)
        super().__init__(
            data_filepath=os.path.join(source_videos_dir, "data.csv"),
            video_index=["id", "camera.idx"],
            pedestrian_index=["pedestrian.idx"],
            clips_index=["clip", "frame.idx"],
            converters={c: convert_to_list for c in (
                "camera.transform", "pedestrian.spawn_point",
                "frame.pedestrian.transform", "frame.pedestrian.velocity",
                "frame.pedestrian.pose.world",
                "frame.pedestrian.pose.component",
                "frame.pedestrian.pose.relative",
                "frame.pedestrian.pose.camera")},
            **kwargs)
        self.source_videos_dir = source_videos_dir

    @property
    def settings(self):
        return {**super().settings, "data_variant": self.data_variant}

    def _read_data(self):
        """The whole CSV, its lists parsed (``fast_dev_run`` does not cut
        this module's read, as in the JAX package)."""
        import pandas as pd

        return pd.read_csv(self.data_filepath, index_col=self.primary_index,
                           converters=self.converters)

    def _clean_filter_sort_data(self, df):
        if "camera.recording" in df.columns:
            df = df.assign(**{"camera.recording": df["camera.recording"]
                              .str.replace(".mp4", "", regex=False)})
        return super()._clean_filter_sort_data(df)

    def _clean_filter_sort_clips(self, clips):
        return [c for c in clips if self._has_pedestrian_in_all_frames(c)]

    def _has_pedestrian_in_all_frames(self, clip) -> bool:
        first = clip.iloc[0]
        w = first.get("camera.width", 800)
        h = first.get("camera.height", 600)
        projection_2d = np.array(
            clip.loc[:, "frame.pedestrian.pose.camera"].to_list(),
            dtype=np.float32)
        return bool(np.all(projection_2d >= 0)
                    and np.all(projection_2d[..., 0] <= w)
                    and np.all(projection_2d[..., 1] <= h))

    def _extract_transform(self, grouped, column: str):
        t = self._reshape_to_sequences(grouped, column)
        return _transform(t)

    def _get_raw_data(self, grouped) -> Tuple[np.ndarray, Dict, Dict]:
        import pandas as pd

        projection_2d = self._reshape_to_sequences(
            grouped, "frame.pedestrian.pose.camera")
        poses = {name: self._extract_transform(grouped, column)
                 for name, column in (
                     ("relative_pose", "frame.pedestrian.pose.relative"),
                     ("absolute_pose", "frame.pedestrian.pose.component"),
                     ("world_pose", "frame.pedestrian.pose.world"),
                     ("world", "frame.pedestrian.transform"))}
        targets = _targets(projection_2d, poses, self._reshape_to_sequences(
            grouped, "frame.pedestrian.velocity"))

        head = grouped.head(1).reset_index(drop=False)
        tail = grouped.tail(1).reset_index(drop=False)
        meta = {
            "video_id": tail.loc[:, "camera.recording"].to_list()
            if "camera.recording" in tail.columns
            else tail.loc[:, "id"].astype(str).to_list(),
            "pedestrian_id": tail.loc[:, ["camera.idx", "pedestrian.idx"]]
            .apply(lambda x: "_".join(str(y) for y in x), axis=1).to_list(),
            "clip_id": tail.loc[:, "clip"].to_numpy().astype(np.int32),
            "age": tail.loc[:, "pedestrian.age"].to_list(),
            "gender": tail.loc[:, "pedestrian.gender"].to_list(),
            "start_frame": head.loc[:, "frame.idx"].to_numpy()
            .astype(np.int32),
            "end_frame": tail.loc[:, "frame.idx"].to_numpy()
            .astype(np.int32) + 1,
            "clip_width": head.get(
                "camera.width", pd.Series([800] * len(head)))
            .to_numpy().astype(np.int32),
            "clip_height": head.get(
                "camera.height", pd.Series([600] * len(head)))
            .to_numpy().astype(np.int32),
        }
        self._add_classification_to_meta(grouped, tail, meta)
        return projection_2d, targets, meta


def _transform(t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(..., 6) transforms (location, euler degrees) -> float32 (..., 3)
    locations and (..., 3, 3) "XYZ" rotation matrices."""
    t = np.asarray(t)
    rot = euler_angles_to_matrix_np(np.deg2rad(t[..., 3:]), "XYZ")
    return t[..., :3].astype(np.float32), rot.astype(np.float32)


def _targets(projection_2d: np.ndarray,
             poses: Dict[str, Tuple[np.ndarray, np.ndarray]],
             velocity: np.ndarray) -> Dict[str, np.ndarray]:
    out = {"bboxes": _np_bboxes(projection_2d)}
    for name, (loc, rot) in poses.items():
        prefix = "world" if name == "world" else name
        out[f"{prefix}_loc"], out[f"{prefix}_rot"] = loc, rot
    out["velocity"] = np.asarray(velocity)
    return out


def recorded_subset(projection_2d: np.ndarray,
                    relative_pose: Tuple[np.ndarray, np.ndarray],
                    absolute_pose: Tuple[np.ndarray, np.ndarray],
                    world_pose: Optional[Tuple[np.ndarray, np.ndarray]]
                    = None,
                    world: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                    velocity: Optional[np.ndarray] = None,
                    crossing: Optional[np.ndarray] = None,
                    age: Optional[Sequence[str]] = None,
                    gender: Optional[Sequence[str]] = None,
                    video_id: Optional[Sequence[str]] = None,
                    clip_size: Tuple[int, int] = (800, 600),
                    targets_key: str = CROSSING_KEY,
                    labels: Sequence[str] = LABELS
                    ) -> Tuple[np.ndarray, Dict, Dict]:
    """A CarlaRecorded subset made in memory: ``(projection_2d, targets,
    meta)`` with the fields, shapes and dtypes that preparing the CSV
    writes (``CarlaRecordedDataModule._get_raw_data`` and the numeric label
    the classification mixin adds), for ``Hdf5DataModule.add_subset``.

    ``projection_2d`` is (N, L, 26, 2) pixels; each pose is (loc (N, L,
    26, 3), rot (N, L, 26, 3, 3)), ``world`` (loc (N, L, 3), rot (N, L, 3,
    3)). Left out: the world pose is the absolute one, the world track
    and the velocity are zero and the identity, nobody crosses, every
    pedestrian an adult female in a video of its own."""
    projection_2d = np.asarray(projection_2d, dtype=np.float32)
    n, length = projection_2d.shape[:2]
    if world is None:
        world = (np.zeros((n, length, 3), np.float32),
                 np.broadcast_to(np.eye(3, dtype=np.float32),
                                 (n, length, 3, 3)).copy())
    poses = {"relative_pose": relative_pose, "absolute_pose": absolute_pose,
             "world_pose": world_pose or absolute_pose, "world": world}
    poses = {k: (np.asarray(loc, np.float32), np.asarray(rot, np.float32))
             for k, (loc, rot) in poses.items()}
    targets = _targets(projection_2d, poses,
                       np.zeros((n, length, 3), np.float32)
                       if velocity is None else velocity)
    crossing = np.zeros(n, bool) if crossing is None \
        else np.asarray(crossing, bool)
    targets[targets_key] = crossing.astype(np.int32)
    meta = {
        "video_id": list(video_id) if video_id is not None
        else [f"video_{i:06d}" for i in range(n)],
        "pedestrian_id": ["0_0"] * n,
        "clip_id": np.zeros(n, np.int32),
        "age": list(age) if age is not None else ["adult"] * n,
        "gender": list(gender) if gender is not None else ["female"] * n,
        "start_frame": np.zeros(n, np.int32),
        "end_frame": np.full(n, length, np.int32),
        "clip_width": np.full(n, clip_size[0], np.int32),
        "clip_height": np.full(n, clip_size[1], np.int32),
        targets_key: [labels[int(c)] for c in crossing],
    }
    return projection_2d, targets, meta


class CarlaBenchmarkDataModule(BenchmarkDataModuleMixin,
                               CarlaRecordedDataModule):
    """CarlaRecorded under the PedestrianActionBenchmark protocol: each
    video's ``crossing_point`` (its first crossing frame, -1 for none) and
    ``crossing`` from ``frame.pedestrian.is_crossing``."""

    def __init__(self, **kwargs):
        kwargs.setdefault("classification_targets_key", "crossing")
        super().__init__(**kwargs)

    def _clean_filter_sort_data(self, df):
        df = super()._clean_filter_sort_data(df)
        if CROSSING_KEY in df.columns:
            def per_video(group):
                crossing_frames = group.loc[
                    group[CROSSING_KEY].astype(bool), "frame.idx"]
                cp = int(crossing_frames.min()) if len(crossing_frames) \
                    else -1
                return group.assign(crossing_point=cp, crossing=cp >= 0)
            df = df.groupby(level=list(range(len(self.primary_index))),
                            group_keys=False).apply(per_video)
        return df
