"""Classification plot artifacts: the confusion matrix, ROC and PR curves
of an evaluation pass, rendered as PNGs into the run's log directory from
the binned metric states (``metrics/classification.py``). ``matplotlib``
is imported only when a plot is drawn."""
import os
from typing import Any, Dict, List, Optional

import numpy as np

_INK = "#3b3b3b"        # primary ink for text/marks
_MUTED = "#9a9a9a"      # reference lines / recessive grid
_LINE = "#3d6fb5"       # single-series line hue
_SEQ_CMAP = "Blues"     # sequential: one hue, light->dark


def _new_axes(title: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(4.2, 4.0), dpi=110)
    ax.set_title(title, color=_INK, fontsize=11)
    for s in ax.spines.values():
        s.set_color(_MUTED)
    ax.tick_params(colors=_INK, labelsize=8)
    return fig, ax


def _save(fig, out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.tight_layout()
    fig.savefig(path)
    import matplotlib.pyplot as plt
    plt.close(fig)
    return path


def _plot_confusion(confusion: np.ndarray, out_dir: str, tag: str,
                    class_names: Optional[List[str]] = None) -> str:
    confusion = np.asarray(confusion)
    n = confusion.shape[0]
    names = class_names or [str(i) for i in range(n)]
    fig, ax = _new_axes(f"Confusion matrix ({tag})")
    im = ax.imshow(confusion, cmap=_SEQ_CMAP, vmin=0)
    ax.set_xlabel("predicted", color=_INK, fontsize=9)
    ax.set_ylabel("true", color=_INK, fontsize=9)
    ax.set_xticks(range(n), names)
    ax.set_yticks(range(n), names)
    # annotate counts in ink that stays readable on both ends of the ramp
    vmax = max(confusion.max(), 1)
    for i in range(n):
        for j in range(n):
            ax.text(j, i, str(int(confusion[i, j])), ha="center",
                    va="center", fontsize=9,
                    color="white" if confusion[i, j] > 0.6 * vmax else _INK)
    fig.colorbar(im, ax=ax, shrink=0.8)
    return _save(fig, out_dir, f"{tag}_confusion_matrix.png")


def _plot_roc(fpr: np.ndarray, tpr: np.ndarray, out_dir: str, tag: str,
              auroc: Optional[float] = None) -> str:
    title = f"ROC ({tag})" if auroc is None \
        else f"ROC ({tag}) — AUROC {auroc:.3f}"
    fig, ax = _new_axes(title)
    ax.plot([0, 1], [0, 1], color=_MUTED, lw=1, ls="--")  # chance line
    ax.plot(np.asarray(fpr), np.asarray(tpr), color=_LINE, lw=2)
    ax.set_xlabel("false positive rate", color=_INK, fontsize=9)
    ax.set_ylabel("true positive rate", color=_INK, fontsize=9)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    ax.grid(color=_MUTED, alpha=0.25, lw=0.5)
    return _save(fig, out_dir, f"{tag}_roc_curve.png")


def _plot_pr(recall: np.ndarray, precision: np.ndarray, out_dir: str,
             tag: str) -> str:
    fig, ax = _new_axes(f"Precision-Recall ({tag})")
    ax.plot(np.asarray(recall), np.asarray(precision), color=_LINE, lw=2)
    ax.set_xlabel("recall", color=_INK, fontsize=9)
    ax.set_ylabel("precision", color=_INK, fontsize=9)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    ax.grid(color=_MUTED, alpha=0.25, lw=0.5)
    return _save(fig, out_dir, f"{tag}_pr_curve.png")


def save_classification_plots(computed: Dict[str, Any], out_dir: str,
                              stage: str, step: int,
                              class_names: Optional[List[str]] = None
                              ) -> List[str]:
    """Render whatever classification artifacts are present in a
    ``MetricCollection.compute`` result. Returns written paths (empty when
    the flow has no classification metrics)."""
    tag = f"{stage}-step={step:0>6d}"
    paths = []
    if "ConfusionMatrix" in computed:
        paths.append(_plot_confusion(np.asarray(computed["ConfusionMatrix"]),
                                     out_dir, tag, class_names))
    if "ROC" in computed and isinstance(computed["ROC"], dict):
        auroc = computed.get("AUROC")
        paths.append(_plot_roc(
            computed["ROC"]["fpr"], computed["ROC"]["tpr"], out_dir, tag,
            auroc=float(np.asarray(auroc)) if auroc is not None else None))
    if "PRCurve" in computed and isinstance(computed["PRCurve"], dict):
        paths.append(_plot_pr(
            computed["PRCurve"]["recall"], computed["PRCurve"]["precision"],
            out_dir, tag))
    return paths
