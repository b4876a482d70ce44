"""Inference closure for serving: the flow's eval path minus targets (model
apply -> FK -> camera projection -> the metric-prediction dict). The
StableHLO export of the JAX package has no counterpart yet."""
from typing import Any, Callable, Dict

import torch


def make_inference_fn(flow, params, output_keys=None
                      ) -> Callable[..., Dict[str, Any]]:
    """Inference closure over ``params`` (a flow parameter dict, the
    models' running statistics included: evaluation normalises by them):
    ``infer(inputs, age_gender_idx) -> preds``. Runs on the flow's device
    (the card, unless the flow was built with ``device="cpu"``).

    ``output_keys`` restricts the returned dict; unknown keys raise.
    """
    device = flow.device
    params = {name: {k: v.to(device) for k, v in tree.items()}
              for name, tree in params.items()}

    @torch.no_grad()
    def infer(inputs, age_gender_idx):
        batch = (torch.as_tensor(inputs, device=device), {},
                 {"age_gender_idx": torch.as_tensor(age_gender_idx,
                                                    device=device)})
        sliced = flow._inner_step(params, batch, training=False)
        preds = flow._metric_preds(sliced)
        preds = {k: v for k, v in preds.items() if v is not None}
        if output_keys is not None:
            missing = set(output_keys) - set(preds)
            if missing:
                raise KeyError(
                    f"output_keys {sorted(missing)} not produced by "
                    f"{type(flow).__name__}; available: {sorted(preds)}")
            preds = {k: preds[k] for k in output_keys}
        return preds
    return infer
