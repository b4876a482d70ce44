"""Pandas clip extraction: an annotations CSV -> sliding-window clips over
the continuous runs of each video's frames -> a video-level split into
train / val / test that never puts one video in two sets, with the clips of
each set shuffled from the datamodule's seed. ``pandas`` is imported inside
the methods that use it."""
import math
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class PandasDataModuleMixin:
    def __init__(self,
                 data_filepath: str,
                 video_index: List[str],
                 pedestrian_index: List[str],
                 clips_index: List[str],
                 converters: Optional[Dict[str, Callable]] = None,
                 df_usecols: Optional[List[str]] = None,
                 df_filters: Optional[Dict[str, List]] = None,
                 extra_cols: Optional[Dict[str, Any]] = None,
                 min_video_length: Optional[int] = None,
                 **kwargs) -> None:
        self.data_filepath = data_filepath
        self.video_index = video_index
        self.pedestrian_index = pedestrian_index
        self.clips_index = clips_index
        self.converters = converters
        self.df_usecols = df_usecols
        self.df_filters = df_filters
        self.extra_cols = extra_cols or {}
        super().__init__(**kwargs)
        self.min_video_length = min_video_length or self.clip_length

    @property
    def primary_index(self) -> List[str]:
        return self.video_index + self.pedestrian_index

    @property
    def full_index(self) -> List[str]:
        return self.primary_index + self.clips_index

    def _reshape_to_sequences(self, grouped, column_name) -> np.ndarray:
        out = np.stack(grouped[column_name].apply(list).to_list())
        if np.issubdtype(out.dtype, np.floating):
            out = out.astype(np.float32)
        return out

    def _read_data(self):
        import pandas as pd

        df = pd.read_csv(
            self.data_filepath,
            usecols=self.df_usecols,
            index_col=self.primary_index,
            converters=self.converters,
            # fast_dev_run reads the first 18,000 rows
            nrows=18000 if getattr(self, "_fast_dev_run", False) else None,
        )
        for k, v in self.extra_cols.items():
            df[k] = pd.Series(dtype=v)
        return df

    def _set_class_labels(self, df) -> None:
        pass

    def _clean_filter_sort_data(self, df):
        if self.df_filters is not None:
            keep = df.isin(self.df_filters)[list(self.df_filters)].all(axis=1)
            df = df[keep]
        sorted_df = df.sort_index()
        self._set_class_labels(sorted_df)
        return sorted_df

    # -- clip extraction ---------------------------------------------------
    def _extract_clips(self, annotations_df) -> List:
        frame_col = self.clips_index[-1]
        clips = []
        for _, video in annotations_df.groupby(level=list(
                range(len(self.primary_index)))):
            video = video.sort_values(frame_col)
            if len(video) < self.min_video_length:
                continue
            frames = video[frame_col].to_numpy()
            # continuous runs: a gap of more than one frame starts a new one
            breaks = np.nonzero(np.diff(frames) > 1)[0] + 1
            run_bounds = zip(np.concatenate([[0], breaks]),
                             np.concatenate([breaks, [len(frames)]]))
            ci = 0
            for start, stop in run_bounds:
                run = video.iloc[start:stop]
                pos = 0
                while pos + self.clip_length <= len(run):
                    clip = run.iloc[pos:pos + self.clip_length] \
                        .reset_index().assign(clip=ci)
                    clips.append(clip)
                    ci += 1
                    pos += self.clip_offset
        return clips

    # -- split & save ------------------------------------------------------
    def _split_and_save_clips(self, clips: List) -> Dict[str, int]:
        import pandas as pd

        set_size: Dict[str, int] = {}
        if not clips:
            warnings.warn("No clips extracted.")
            return set_size
        all_clips = pd.concat(clips).set_index(self.full_index).sort_index()
        all_clips.reset_index(drop=False, inplace=True)

        # clips per video, the most populous first
        clip_counts = all_clips.loc[:, self.primary_index
                                    + self.clips_index[0:1]] \
            .drop_duplicates().groupby(self.video_index) \
            .agg(clips_count=(self.clips_index[0], "count")) \
            .sort_values("clips_count", ascending=False)
        total = int(clip_counts["clips_count"].sum())

        test_count = max(math.floor(total * self.test_set_frac), 1) \
            if self.test_set_frac > 0 else 0
        val_count = max(math.floor((total - test_count) * self.val_set_frac),
                        1) if self.val_set_frac > 0 else 0

        # whole videos go round robin into the sets, the biggest first
        targets_counts = [total - test_count - val_count, val_count,
                          test_count]
        assigned_sets: List[List[Any]] = [[], [], []]
        current = [0, 0, 0]
        for video_id, row in clip_counts.iterrows():
            # into the set with the largest relative deficit
            deficits = [
                (targets_counts[i] - current[i]) / max(targets_counts[i], 1)
                for i in range(3)]
            i = int(np.argmax(deficits))
            if targets_counts[i] == 0:
                i = 0
            assigned_sets[i].append(video_id)
            current[i] += int(row["clips_count"])

        keyed = all_clips.set_index(self.video_index)
        for i, name in enumerate(("train", "val", "test")):
            if not assigned_sets[i]:
                warnings.warn(f"No clips assigned to {name} set.")
                continue
            clips_set = keyed.loc[keyed.index.isin(assigned_sets[i])]
            set_size[name] = self._process_clips_set(name, clips_set.copy())
        return set_size

    def _process_clips_set(self, name: str, clips_set) -> int:
        clips_set.reset_index(inplace=True, drop=False)
        group_cols = self.primary_index + self.clips_index[:-1]
        clips_set.set_index(group_cols, inplace=True)

        # shuffle whole clips
        unique_idx = clips_set.index.drop_duplicates()
        rng = np.random.default_rng(getattr(self, "seed", 22742))
        order = rng.permutation(len(unique_idx))
        shuffled = clips_set.loc[unique_idx[order]]

        grouped = shuffled.groupby(level=list(range(len(group_cols))),
                                   sort=False)
        projection_2d, targets, meta = self._get_raw_data(grouped)
        return self._save_subset(name, projection_2d, targets, meta)

    def _get_raw_data(self, grouped) -> Tuple[np.ndarray, Dict, Dict]:
        raise NotImplementedError
