"""Classification labels in the clip meta and the numeric label as a
target, class counts, optional train-set class balancing, and the
PedestrianActionBenchmark clip window (``BenchmarkDataModuleMixin``)."""
from typing import Dict, Iterable, Tuple

import numpy as np


class ClassificationDataModuleMixin:
    def __init__(self,
                 classification_targets_key: str = "cross",
                 num_classes: int = 2,
                 label_frames: float = -1,
                 label_mapping: Tuple = ("not-crossing", "crossing",
                                         "irrelevant"),
                 balance_classes: bool = False,
                 **kwargs):
        self._classification_targets_key = classification_targets_key
        self._label_frames = label_frames
        self._label_mapping = list(label_mapping[:num_classes])
        self._num_classes = num_classes
        self._balance_classes = balance_classes
        super().__init__(**kwargs)

    @property
    def settings(self):
        return {**super().settings,
                "label_frames": self._label_frames,
                "num_classes": self._num_classes,
                "classification_targets_key":
                    self._classification_targets_key,
                "balance_classes": self._balance_classes}

    def _set_class_labels(self, df) -> None:
        # crossing is explicitly index 1 so binary classifiers can use it
        self._class_labels = {
            self._classification_targets_key: self._label_mapping}

    def _add_classification_to_meta(self, grouped, grouped_tail, meta):
        """Label = the last frame's value, or whether any frame of the last
        ``label_frames`` fraction of the clip has it."""
        key = self._classification_targets_key
        if key not in grouped_tail.columns:
            return
        if self._label_frames < 0:
            values = grouped_tail.loc[:, key].to_numpy()
        else:
            cutoffs = np.ceil(grouped.size().to_numpy()
                              * self._label_frames).astype(int) * -1
            values = np.asarray([
                bool(np.any(rows.loc[:, key].iloc[cutoff:].to_numpy()))
                for cutoff, (_, rows) in zip(cutoffs, grouped)])
        labels = self._class_labels[key]
        meta[key] = [labels[int(bool(v) if isinstance(v, (bool, np.bool_))
                                else int(v))] for v in values]

    def _set_class_counts(self, set_name: str, meta: Dict[str, Iterable]):
        if self._class_labels is None:
            return
        for class_key, class_labels in self._class_labels.items():
            if class_key not in meta:
                continue
            numeric = np.array([class_labels.index(k) for k in meta[class_key]])
            counts = np.bincount(numeric, minlength=self._num_classes)
            self._class_counts[set_name][class_key] = {
                label: int(counts[i]) for i, label in enumerate(class_labels)}

    def _save_subset(self, name, projection_2d, targets, meta, save_dir=None):
        key = self._classification_targets_key
        # store the numeric label as a target so flows can compute the loss
        if key in meta:
            labels = self._class_labels[key]
            targets = {**targets, key: np.array(
                [labels.index(v) for v in meta[key]], dtype=np.int32)}
        if name == "train" and self._balance_classes and key in meta:
            numeric = np.array([self._class_labels[key].index(k)
                                for k in meta[key]])
            counts = np.bincount(numeric, minlength=self._num_classes)
            min_count = int(counts.min())
            mask = np.zeros(len(projection_2d), dtype=bool)
            for ci in range(self._num_classes):
                idx = np.nonzero(numeric == ci)[0][:min_count]
                mask[idx] = True
            projection_2d = projection_2d[mask]
            targets = {k: np.asarray(v)[mask] for k, v in targets.items()}
            meta = {k: np.asarray(v)[mask] for k, v in meta.items()}
        size = super()._save_subset(name, projection_2d, targets, meta,
                                    save_dir)
        self._set_class_counts(name, meta)
        return size


class BenchmarkDataModuleMixin:
    """The PedestrianActionBenchmark protocol (Kotseruba et al., WACV'21):
    clips end within the time-to-event window [30, 60] frames before the
    crossing point."""

    def __init__(self, tte: Tuple[int, int] = (30, 60), **kwargs):
        self.tte = sorted(tte) if len(tte) else [30, 60]
        kwargs.setdefault("clip_length", 16)
        kwargs.setdefault("clip_offset", 6)
        kwargs.setdefault("classification_targets_key", "crossing")
        kwargs["min_video_length"] = kwargs["clip_length"] + self.tte[1]
        kwargs["label_frames"] = -1
        super().__init__(**kwargs)

    @property
    def settings(self):
        return {**super().settings, "tte": self.tte}

    def _extract_clips(self, annotations_df):
        """Trim each video to the TTE-relevant window before clip windowing."""
        frame_col = self.clips_index[-1]
        trimmed = []
        for idx, video in annotations_df.groupby(
                level=list(range(len(self.primary_index)))):
            video = video.sort_values(frame_col)
            if "crossing_point" in video.columns:
                cp = video.iloc[-1].crossing_point
                video = video.loc[(video[frame_col] <= video.crossing_point)
                                  | (video.crossing_point < 0)]
                if not len(video):
                    continue
                event_frame = video.iloc[-1][frame_col] - 3 if cp < 0 else cp
                start = max(0, event_frame - self.clip_length - self.tte[1])
                end = event_frame - self.tte[0]
                video = video[(video[frame_col] >= start)
                              & (video[frame_col] <= end)]
            if len(video) >= self.clip_length:
                trimmed.append(video)
        if not trimmed:
            return []
        import pandas as pd

        # min_video_length gated the *untrimmed* videos; the trimmed
        # remainder only needs to fit one clip
        orig = self.min_video_length
        self.min_video_length = self.clip_length
        try:
            return super()._extract_clips(pd.concat(trimmed))
        finally:
            self.min_video_length = orig
