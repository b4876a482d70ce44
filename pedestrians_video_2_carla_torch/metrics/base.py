"""Metric framework: stateless metric objects whose accumulator state is an
additive dict of tensors on the device (the JAX package's
``metrics/base.py``; its cross-device ``psum`` has no counterpart on one
card)."""
from typing import Any, Dict

import torch


class Metric:
    """Interface of an additive-state metric: ``init_state(device)`` -> a
    dict of zero tensors; ``update(state, preds, targets)`` -> the new
    state; ``compute(state)`` -> a scalar tensor, a tensor or a dict of
    them. A missing input key makes ``update`` a no-op."""

    def init_state(self, device=None) -> Any:
        raise NotImplementedError

    def update(self, state: Any, preds: Dict[str, torch.Tensor],
               targets: Dict[str, torch.Tensor]) -> Any:
        raise NotImplementedError

    def compute(self, state: Any):
        raise NotImplementedError


class MetricCollection:
    """Named metrics sharing the update / compute protocol."""

    def __init__(self, metrics: Dict[str, Metric]):
        self.metrics = dict(metrics)

    def init_state(self, device=None) -> Dict[str, Any]:
        return {name: m.init_state(device)
                for name, m in self.metrics.items()}

    @torch.no_grad()
    def update(self, state: Dict[str, Any], preds, targets) -> Dict[str, Any]:
        return {name: m.update(state[name], preds, targets)
                for name, m in self.metrics.items()}

    @torch.no_grad()
    def compute(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return {name: m.compute(state[name])
                for name, m in self.metrics.items()}

    def compute_moved(self, state: Dict[str, Any], device=None
                      ) -> Dict[str, Any]:
        """:meth:`compute`, without the metrics whose state never left its
        init (their ``update`` found no input in any batch: an MPJPE fed 2D
        predictions); those are absent, not a perfect 0."""
        init = self.init_state(device)
        computed = self.compute(state)
        for name in list(computed):
            if all(torch.equal(init[name][k], state[name][k])
                   for k in init[name]):
                del computed[name]
        return computed

    def __len__(self) -> int:
        return len(self.metrics)


def safe_div(num, den):
    """num / den with 0 where den <= 0. The guard denominator only kicks in
    where den <= 0: clamping every den below 1 up to 1 would return the
    numerator for fractional denominators (F1's precision + recall < 1)."""
    den = torch.as_tensor(den)
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(den))
