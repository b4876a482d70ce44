"""AMASS mocap datamodule: ``.npz`` mocaps -> 60 to 30 fps decimation ->
the yaw-only root-orientation recovery -> SMPL joints (from the body model,
or zero-length bones where there is no model file) -> the conventions
rotation -> 2D projections as the ground truth.

:func:`amass_subset` computes a subset's arrays from the mocaps' poses on
any device, without pandas or h5py, for ``Hdf5DataModule.add_subset``;
``AMASSDataModule.prepare_data`` runs the same function over the clips it
extracts. ``pandas`` is imported only where the mocaps are read and the
clips split.
"""
import glob
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...ops import camera as C
from ...ops.kinematics import forward_kinematics
from ...ops.rotations import euler_angles_to_matrix
from ...skeletons.smpl import SMPL_SKELETON, map_from_original
from ...utils.device import DeviceLike, resolve_device
from ..base.hdf5_datamodule import Hdf5DataModule
from ..base.pandas_mixin import PandasDataModuleMixin
from .body_model import BodyModelData, get_body_model, joint_locations

AMASS_DIR = "AMASS"
#: AMASS records at 60 fps; a clip takes every second frame
FPS_RATIO = 2

#: SMPL -> PyTorch3D world conventions rotation (row-vector)
CONVENTIONS_ROT = np.asarray([
    (1.0, 0.0, 0.0),
    (0.0, 0.0, -1.0),
    (0.0, 1.0, 0.0),
], dtype=np.float32)

#: the SMPL kinematic tree in SMPL_SKELETON's order
SMPL_PARENTS = (-1, 0, 1, 2, 3, 4, 5, 6, 3, 8, 3, 10, 11, 12, 0, 14, 15, 16,
                0, 18, 19, 20)

BodyModelLike = Union[None, BodyModelData,
                      Callable[[str], Optional[BodyModelData]]]


def amass_camera(image_size: Tuple[int, int] = C.DEFAULT_IMAGE_SIZE
                 ) -> C.PinholeCamera:
    """The camera of the AMASS projections: 3.1 m away, at the height of
    the pelvis, looking at it."""
    return C.make_camera(distance=3.1, shift=0.0, elevation=0.0,
                         look_at=(0.0, 0.0, 0.0), image_size=image_size)


def clip_starts(num_frames: int, clip_length: int, clip_offset: int,
                fast_dev_run: bool = False) -> List[int]:
    """The 60 fps start frames of a mocap's clips: every ``2 *
    clip_offset`` frames while ``2 * clip_length`` frames (and one more)
    remain; only the first where ``fast_dev_run``."""
    end = num_frames - clip_length * FPS_RATIO - FPS_RATIO + 1
    starts = list(range(0, max(end, 0), clip_offset * FPS_RATIO))
    return starts[:1] if fast_dev_run else starts


def root_orient_and_world_rot(root_aa: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The yaw-only root-orientation recovery of clips: the clip's mean
    root orientation snapped to the nearest rotation by quarter turns
    about the axes, only the yaw kept and re-zeroed at the first frame;
    that yaw track is the world rotation and the root orientation becomes
    zero.

    :param root_aa: (C, L, 3) float32 axis-angle root orientations.
    :return: (zeros (C, L, 3), world_rot (C, L, 3, 3)).
    """
    axes = root_aa * 2.0 / np.pi
    snapped = torch.round(axes.mean(dim=-2)) * math.pi / 2.0
    axes_rot = torch.round(euler_angles_to_matrix(snapped, "XYZ"))
    a = axes_rot[..., None, :, :]
    root = (a[..., 0] * root_aa[..., 0, None]
            + a[..., 1] * root_aa[..., 1, None]
            + a[..., 2] * root_aa[..., 2, None])          # (axes_rot @ r.T).T
    yaw = torch.stack([torch.zeros_like(root[..., 0]),
                       torch.zeros_like(root[..., 1]), root[..., 2]], dim=-1)
    yaw_mtx = euler_angles_to_matrix(yaw, "XYZ")            # (C, L, 3, 3)
    first_t = yaw_mtx[..., :1, :, :].transpose(-1, -2)
    world_rot = (first_t.unsqueeze(-1) * yaw_mtx.unsqueeze(-3)).sum(-2)
    return torch.zeros_like(root), world_rot


def amass_clip_arrays(pose: torch.Tensor, genders: Sequence[str],
                      body_model: BodyModelLike = None
                      ) -> Dict[str, torch.Tensor]:
    """The arrays of AMASS clips, on ``pose``'s device.

    :param pose: (C, L, 66) float32 decimated axis-angle poses (SMPL's
        first 22 joints in their original order).
    :param genders: C genders, each selecting the clip's body model.
    :param body_model: a body model for every clip, or ``gender -> model
        or None``; None (or a None model) gives zero-length bones.
    :return: ``amass_body_pose`` (C, L, 66) with the root zeroed,
        ``world_rot`` (C, L, 3, 3), ``relative_rot`` / ``absolute_rot``
        (C, L, 22, 3, 3), ``absolute_loc`` (C, L, 22, 3) and
        ``projection_2d`` (C, L, 22, 2).
    """
    pose = pose.float()
    n_clips, length = pose.shape[:2]
    smpl_len = len(SMPL_SKELETON)
    root, world_rot = root_orient_and_world_rot(pose[..., 0:3])
    pose = torch.cat([root, pose[..., 3:]], dim=-1)

    # the axis-angle triplets read as XYZ eulers
    rel_rot = euler_angles_to_matrix(
        map_from_original(pose.reshape(n_clips, length, smpl_len, 3)), "XYZ")

    abs_loc = pose.new_zeros((n_clips, length, smpl_len, 3))
    by_model: Dict[int, Tuple[BodyModelData, List[int]]] = {}
    for i, gender in enumerate(genders):
        model = body_model(gender) if callable(body_model) else body_model
        if model is not None:
            by_model.setdefault(id(model), (model, []))[1].append(i)
    for model, rows in by_model.values():
        idx = torch.as_tensor(rows, device=pose.device)
        sub = pose.index_select(0, idx)
        jtr = joint_locations(model, sub[..., 3:smpl_len * 3],
                              sub[..., :3])[..., :smpl_len, :]
        abs_loc.index_copy_(0, idx, map_from_original(jtr))
    # @ CONVENTIONS_ROT: (x, y, z) -> (x, z, -y)
    abs_loc = torch.stack([abs_loc[..., 0], abs_loc[..., 2],
                           -abs_loc[..., 1]], dim=-1)

    _, abs_rot = forward_kinematics(torch.zeros_like(abs_loc), rel_rot,
                                    parents=SMPL_PARENTS)
    projections = C.project_pose(amass_camera(), abs_loc,
                                 world_rot=world_rot)[..., :2]
    return {"amass_body_pose": pose, "world_rot": world_rot,
            "relative_rot": rel_rot, "absolute_loc": abs_loc,
            "absolute_rot": abs_rot, "projection_2d": projections}


def amass_subset(poses: Sequence[np.ndarray], genders: Sequence[str],
                 clip_length: int, clip_offset: Optional[int] = None,
                 datasets: Optional[Sequence[str]] = None,
                 ids: Optional[Sequence[str]] = None,
                 ages: Optional[Sequence[str]] = None,
                 body_model: BodyModelLike = None,
                 fast_dev_run: bool = False,
                 device: DeviceLike = None
                 ) -> Tuple[np.ndarray, Dict[str, np.ndarray], Dict]:
    """An AMASS subset made from mocaps in memory, its arrays computed on
    ``device`` (the card unless the caller asks for the CPU): the clips of
    every mocap in order, with the fields, shapes and dtypes that
    ``AMASSDataModule`` writes, as host arrays for
    ``Hdf5DataModule.add_subset``.

    :param poses: per mocap a (T, >= 66) 60 fps axis-angle pose array.
    :param genders: per mocap its gender (its body model's).
    :return: ``(projection_2d (N, L, 22, 2), targets, meta)``.
    """
    device = resolve_device(device)
    clip_offset = clip_offset or clip_length
    smpl_len = len(SMPL_SKELETON)
    n = len(poses)
    datasets = list(datasets) if datasets is not None else ["AMASS"] * n
    ids = list(ids) if ids is not None else [f"mocap_{i}" for i in range(n)]
    ages = list(ages) if ages is not None else ["adult"] * n
    frames, meta_rows = [], []
    offset = 0
    step = np.arange(clip_length) * FPS_RATIO
    for m, p in enumerate(poses):
        for c, s in enumerate(clip_starts(len(p), clip_length, clip_offset,
                                          fast_dev_run)):
            frames.append(offset + s + step)
            meta_rows.append((datasets[m], ids[m], c, ages[m], genders[m]))
        offset += len(p)
    if not frames:
        raise ValueError("no mocap is long enough for one clip")
    flat = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [np.asarray(p)[:, :smpl_len * 3] for p in poses]),
        dtype=np.float32)).to(device)
    index = torch.from_numpy(np.stack(frames).reshape(-1)).to(device)
    pose = flat.index_select(0, index).view(len(frames), clip_length, -1)
    arrays = {k: v.cpu().numpy() for k, v in amass_clip_arrays(
        pose, [r[4] for r in meta_rows], body_model).items()}
    return _subset(arrays, meta_rows, clip_length)


def _subset(arrays: Dict[str, np.ndarray], meta_rows: Sequence[tuple],
            clip_length: int) -> Tuple[np.ndarray, Dict, Dict]:
    """(projection_2d, targets, meta) of clips' arrays and their (dataset,
    id, clip, age, gender) rows."""
    targets = {
        "relative_pose_rot": arrays["relative_rot"],
        "absolute_pose_loc": arrays["absolute_loc"],
        "absolute_pose_rot": arrays["absolute_rot"],
        "world_rot": arrays["world_rot"],
        "amass_body_pose": arrays["amass_body_pose"],
    }
    n = len(meta_rows)
    meta = {
        "video_id": [r[0] for r in meta_rows],
        "pedestrian_id": [r[1] for r in meta_rows],
        "clip_id": np.asarray([r[2] for r in meta_rows], np.int32),
        "age": [r[3] for r in meta_rows],
        "gender": [r[4] for r in meta_rows],
        "start_frame": np.zeros(n, np.int32),
        "end_frame": np.full(n, clip_length, np.int32),
    }
    return arrays["projection_2d"], targets, meta


class AMASSDataModule(PandasDataModuleMixin, Hdf5DataModule):
    default_data_nodes = SMPL_SKELETON

    def __init__(self, datasets_dir: str = "datasets",
                 use_body_model: bool = True, **kwargs):
        kwargs.setdefault("data_nodes", SMPL_SKELETON)
        self.datasets_dir = datasets_dir
        self.use_body_model = use_body_model
        self.available_datasets: List[str] = []
        super().__init__(
            data_filepath=None,
            video_index=["dataset", "id"],
            pedestrian_index=[],
            clips_index=["clip", "frame"],
            **kwargs)
        self.amass_dir = os.path.join(datasets_dir, AMASS_DIR)

    @property
    def settings(self):
        return {**super().settings, "datasets": self.available_datasets}

    def _read_data(self):
        """Every ``.npz`` with ``poses`` under ``<datasets_dir>/AMASS``:
        its dataset is its first directory, its id the rest of its path
        without the suffix."""
        import pandas as pd

        mocaps = []
        base_len = len(self.amass_dir) + 1
        for path in glob.glob(os.path.join(self.amass_dir, "**", "*.npz"),
                              recursive=True):
            with np.load(path, mmap_mode="r") as mocap:
                if "poses" not in mocap:
                    continue
                rel = path[base_len:]
                mocaps.append({
                    "dataset": rel.split(os.path.sep)[0],
                    "id": rel.split(os.path.sep, 1)[-1].removesuffix(".npz"),
                    "poses": np.asarray(mocap["poses"]),
                    "gender": str(mocap["gender"]) if "gender" in mocap
                    else "neutral",
                    "age": str(mocap["age"]) if "age" in mocap else "adult",
                })
        df = pd.DataFrame(mocaps)
        if len(df):
            self.available_datasets = sorted(df["dataset"].unique())
        return df

    def _clean_filter_sort_data(self, df):
        return df

    def _extract_clips(self, mocaps) -> List:
        """One frame table per clip: the identity columns and the decimated
        pose (its root still the mocap's)."""
        import pandas as pd

        clips = []
        smpl_len = len(SMPL_SKELETON)
        for _, mocap in mocaps.iterrows():
            starts = clip_starts(mocap["poses"].shape[0], self.clip_length,
                                 self.clip_offset, self._fast_dev_run)
            for clip_idx, start in enumerate(starts):
                pose = np.asarray(
                    mocap["poses"][start:start + self.clip_length
                                   * FPS_RATIO:FPS_RATIO, :smpl_len * 3],
                    dtype=np.float32)
                frames = pd.DataFrame({
                    "dataset": str(mocap["dataset"]),
                    "id": str(mocap["id"]),
                    "clip": clip_idx,
                    "gender": str(mocap["gender"]),
                    "age": str(mocap["age"]),
                    "frame": list(range(len(pose))),
                })
                frames["amass_body_pose"] = [pose[i] for i in range(len(pose))]
                clips.append(frames)
        return clips

    def _body_model(self, gender: str) -> Optional[BodyModelData]:
        """The cached body model of ``gender`` (neutral for another
        value), None where it is not used or its file is missing."""
        if not self.use_body_model:
            return None
        try:
            return get_body_model(gender if gender in
                                  ("male", "female", "neutral")
                                  else "neutral")
        except FileNotFoundError:
            return None

    def _extract_additional_data(self, clips):
        """Every clip's arrays through :func:`amass_clip_arrays`, on the
        CPU."""
        if not clips:
            return clips
        pose = torch.from_numpy(np.stack([
            np.stack(c["amass_body_pose"].to_list()) for c in clips]))
        arrays = amass_clip_arrays(
            pose, [str(c.iloc[0]["gender"]) for c in clips],
            self._body_model)
        arrays = {k: v.numpy() for k, v in arrays.items()}
        updated = []
        for i, clip in enumerate(clips):
            clip = clip.copy()
            for k, v in arrays.items():
                clip[k] = list(v[i])
            updated.append(clip)
        return updated

    def _get_raw_data(self, grouped) -> Tuple[np.ndarray, Dict, Dict]:
        projection_2d = self._reshape_to_sequences(grouped, "projection_2d")
        arrays = {k: self._reshape_to_sequences(grouped, k) for k in (
            "relative_rot", "absolute_loc", "absolute_rot", "world_rot",
            "amass_body_pose")}
        arrays["projection_2d"] = projection_2d
        tail = grouped.tail(1).reset_index(drop=False)
        head = grouped.head(1).reset_index(drop=False)
        rows = list(zip(tail["dataset"].to_list(), tail["id"].to_list(),
                        tail["clip"].to_list(), tail["age"].to_list(),
                        tail["gender"].to_list()))
        projection_2d, targets, meta = _subset(arrays, rows,
                                               projection_2d.shape[1])
        meta["start_frame"] = head["frame"].to_numpy().astype(np.int32)
        meta["end_frame"] = tail["frame"].to_numpy().astype(np.int32) + 1
        return projection_2d, targets, meta
