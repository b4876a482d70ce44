"""Classification metrics: confusion-matrix-derived Accuracy / Precision /
Recall / F1 (micro / macro / weighted / none averaging), the confusion
matrix itself, and binned-threshold AUROC / ROC / PR curves (the JAX
package's ``metrics/classification.py``). States are additive count tensors
on the device; the AUROC and curve metrics use fixed-bin score histograms
instead of storing every prediction."""
import torch

from .base import Metric, safe_div

DEFAULT_BINS = 127


def _logits_to_pred_and_score(logits: torch.Tensor, binary: bool):
    """-> (predicted class (N,), positive-class score (N,))."""
    if binary or logits.ndim == 1 or logits.shape[-1] == 1:
        score = torch.sigmoid(logits.reshape(logits.shape[0], -1)[:, -1])
        return (score > 0.5).long(), score
    probs = torch.softmax(logits, dim=-1)
    return torch.argmax(logits, dim=-1), probs[..., 1]


class ConfusionMatrixMetric(Metric):
    """counts[target, prediction]; the basis of the derived metrics."""

    def __init__(self, preds_key: str = "crossing_logits",
                 targets_key: str = "crossing", num_classes: int = 2,
                 binary: bool = False):
        self.preds_key = preds_key
        self.targets_key = targets_key
        self.num_classes = num_classes
        self.binary = binary

    def init_state(self, device=None):
        return {"confusion": torch.zeros(
            (self.num_classes, self.num_classes), dtype=torch.int64,
            device=device)}

    def update(self, state, preds, targets):
        if preds.get(self.preds_key) is None \
                or targets.get(self.targets_key) is None:
            return state
        gt = targets[self.targets_key].reshape(-1).long()
        pred, _ = _logits_to_pred_and_score(preds[self.preds_key],
                                            self.binary)
        counts = torch.bincount(gt * self.num_classes + pred,
                                minlength=self.num_classes ** 2)
        return {"confusion": state["confusion"] + counts[
            :self.num_classes ** 2].reshape(self.num_classes,
                                            self.num_classes)}

    def compute(self, state):
        return state["confusion"]


class _DerivedFromConfusion(ConfusionMatrixMetric):
    def __init__(self, *args, average: str = "macro", **kwargs):
        super().__init__(*args, **kwargs)
        self.average = average

    def _stats(self, confusion):
        confusion = confusion.float()
        tp = torch.diagonal(confusion)
        support = confusion.sum(dim=1)       # per true class
        predicted = confusion.sum(dim=0)     # per predicted class
        return tp, support, predicted, confusion.sum()

    def _maybe_average(self, per_class, support):
        if self.average == "none":
            return {str(i): per_class[i] for i in range(self.num_classes)}
        if self.average == "weighted":
            return (per_class * support).sum() / support.sum().clamp_min(1)
        return per_class.mean()  # macro


class Accuracy(_DerivedFromConfusion):
    def compute(self, state):
        tp, support, _, total = self._stats(state["confusion"])
        if self.average == "micro":
            return safe_div(tp.sum(), total)
        return self._maybe_average(safe_div(tp, support), support)


class Precision(_DerivedFromConfusion):
    def compute(self, state):
        tp, support, predicted, total = self._stats(state["confusion"])
        if self.average == "micro":
            return safe_div(tp.sum(), total)
        return self._maybe_average(safe_div(tp, predicted), support)


class Recall(_DerivedFromConfusion):
    def compute(self, state):
        tp, support, _, total = self._stats(state["confusion"])
        if self.average == "micro":
            return safe_div(tp.sum(), total)
        return self._maybe_average(safe_div(tp, support), support)


class F1Score(_DerivedFromConfusion):
    def compute(self, state):
        tp, support, predicted, total = self._stats(state["confusion"])
        if self.average == "micro":
            return safe_div(tp.sum(), total)
        precision = safe_div(tp, predicted)
        recall = safe_div(tp, support)
        per_class = safe_div(2 * precision * recall, precision + recall)
        return self._maybe_average(per_class, support)


class _ScoreHistogram(Metric):
    """Positive / negative score histograms over fixed bins: the shared
    state of AUROC and the ROC / PR curves."""

    def __init__(self, preds_key: str = "crossing_logits",
                 targets_key: str = "crossing", num_classes: int = 2,
                 binary: bool = False, bins: int = DEFAULT_BINS):
        self.preds_key = preds_key
        self.targets_key = targets_key
        self.binary = binary
        self.bins = bins

    def init_state(self, device=None):
        return {"pos": torch.zeros(self.bins, dtype=torch.int64,
                                   device=device),
                "neg": torch.zeros(self.bins, dtype=torch.int64,
                                   device=device)}

    def update(self, state, preds, targets):
        if preds.get(self.preds_key) is None \
                or targets.get(self.targets_key) is None:
            return state
        gt = targets[self.targets_key].reshape(-1).long()
        _, score = _logits_to_pred_and_score(preds[self.preds_key],
                                             self.binary)
        bin_idx = (score * self.bins).long().clamp(0, self.bins - 1)
        spare = torch.full_like(bin_idx, self.bins)
        pos = torch.bincount(torch.where(gt == 1, bin_idx, spare),
                             minlength=self.bins + 1)[:self.bins]
        neg = torch.bincount(torch.where(gt == 0, bin_idx, spare),
                             minlength=self.bins + 1)[:self.bins]
        return {"pos": state["pos"] + pos, "neg": state["neg"] + neg}

    def _curves(self, state):
        # thresholds sweep from high to low: cumulative sums from the top bin
        tp = torch.cumsum(state["pos"].flip(0).float(), dim=0)
        fp = torch.cumsum(state["neg"].flip(0).float(), dim=0)
        return (safe_div(fp, fp[-1]), safe_div(tp, tp[-1]),
                safe_div(tp, tp + fp))


class AUROC(_ScoreHistogram):
    def compute(self, state):
        fpr, tpr, _ = self._curves(state)
        zero = fpr.new_zeros(1)
        return torch.trapezoid(torch.cat([zero, tpr]), torch.cat([zero, fpr]))


class ROCCurve(_ScoreHistogram):
    def compute(self, state):
        fpr, tpr, _ = self._curves(state)
        return {"fpr": fpr, "tpr": tpr}


class PRCurve(_ScoreHistogram):
    def compute(self, state):
        _, tpr, precision = self._curves(state)
        return {"recall": tpr, "precision": precision}
