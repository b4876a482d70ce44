"""Serving: the flow's eval path minus targets as an inference closure, and
its export to a file that serves without the flow (the JAX package's
``serving.py``).

``make_inference_fn`` closes over a flow's parameters: ``infer(inputs,
age_gender_idx) -> preds`` (model apply -> FK -> camera projection -> the
metric-prediction dict; a classifier's logits).

``export_inference`` traces that closure with ``torch.export`` and writes
the program, its weights baked in as constants, to ``path`` (a ``.pt2``)
and its meta to ``path + ".json"``. The hand-written forward kernels are
``torch.library`` ops of the ``pv2c`` namespace (``ops/fused_*.py``), so
each is one node of the exported graph: the CUDA kernel where the program
runs on the card, the plain version where it runs on the CPU.
``load_inference`` reads the file back, on the card or, with
``device="cpu"``, on the CPU, and needs neither the flow nor the model
classes: only the op modules, which it imports.
"""
import importlib
import json
import os
from typing import Any, Callable, Dict, Tuple

import torch

from .utils.device import DeviceLike, resolve_device

#: the modules that register the ``pv2c`` ops an artifact may call
OP_MODULES = ("fused_projection", "fused_spatial_transformer",
              "fused_temporal_transformer", "fused_graph_gru")


def _predict_fn(flow, params, output_keys=None
                ) -> Callable[..., Dict[str, Any]]:
    """The inference closure without its ``no_grad``: the function that
    :func:`make_inference_fn` wraps and :func:`export_inference` traces."""
    device = flow.device
    params = {name: {k: v.detach().to(device) for k, v in tree.items()}
              for name, tree in params.items()}

    if not hasattr(flow, "_inner_step"):  # ClassificationFlow
        def predict(inputs, age_gender_idx):
            logits = flow._apply(params, torch.as_tensor(inputs,
                                                         device=device),
                                 False)
            return {flow.outputs_key: logits}
        return predict

    def predict(inputs, age_gender_idx):
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
    return predict


def make_inference_fn(flow, params, output_keys=None
                      ) -> Callable[..., Dict[str, Any]]:
    """Inference closure over ``params`` (a flow parameter dict, the
    models' running statistics included: evaluation normalises by them):
    ``infer(inputs, age_gender_idx) -> preds``. Runs on the flow's device
    (the card, unless the flow was built with ``device="cpu"``). Works for
    the flows with an ``_inner_step`` (pose lifting, autoencoder) and for
    ``ClassificationFlow`` (``{flow.outputs_key: logits}``).

    ``output_keys`` restricts the returned dict of the former; unknown
    keys raise. The classifier's closure returns its logits alone, as the
    JAX package's does.
    """
    return torch.no_grad()(_predict_fn(flow, params, output_keys))


class _Served(torch.nn.Module):
    def __init__(self, predict):
        super().__init__()
        self.predict = predict

    def forward(self, inputs, age_gender_idx):
        return self.predict(inputs, age_gender_idx)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def export_inference(flow, params, sample_inputs, sample_age_gender_idx,
                     path: str, output_keys=None,
                     polymorphic_batch: bool = False) -> str:
    """Export the flow's inference closure to ``path`` (``torch.export``,
    saved with ``torch.export.save``) and its meta to ``path + ".json"``
    (the JAX package's keys: ``input_shapes``, ``input_dtypes``, ``flow``,
    ``platforms``, the device type it was exported on, and
    ``output_keys``). Returns ``path``.

    Shapes are fixed to the samples' unless ``polymorphic_batch``: then
    the batch axis of both inputs is one symbolic dimension ``b`` and one
    artifact serves every batch size. That needs ``projection_kernel ==
    "plain"`` (the JAX rule for its ``xla`` route); another route raises
    ``ValueError``.
    """
    if polymorphic_batch and getattr(flow, "projection_kernel",
                                     "plain") != "plain":
        raise ValueError(
            "polymorphic_batch=True requires projection_kernel='plain', as "
            "the JAX package requires its 'xla' route")
    device = flow.device
    inputs = torch.as_tensor(sample_inputs, device=device)
    age_gender_idx = torch.as_tensor(sample_age_gender_idx, device=device)
    predict = _predict_fn(flow, params, output_keys)
    with torch.no_grad():
        # one eager call first: the constant tables that the eval path
        # makes once per device (reference skeletons, FK levels, index
        # tables) are then real tensors, which the trace takes as
        # constants, and not made while tracing
        keys = sorted(predict(inputs, age_gender_idx))
        dynamic_shapes = None
        if polymorphic_batch:
            b = torch.export.Dim("b")
            dynamic_shapes = ({0: b}, {0: b})
        program = torch.export.export(
            _Served(predict), (inputs, age_gender_idx),
            dynamic_shapes=dynamic_shapes, strict=False)
    # the trace keeps every operation it recorded, also those no output
    # reads (the plane path where only projection_2d is kept); the JAX
    # package's lowering drops them, and so does this
    program.graph.eliminate_dead_code()
    program.graph_module.recompile()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    shapes = [list(inputs.shape), list(age_gender_idx.shape)]
    if polymorphic_batch:
        shapes = [["b"] + [str(d) for d in s[1:]] for s in shapes]
    with open(path + ".json", "w") as f:
        json.dump({
            "input_shapes": shapes,
            "input_dtypes": [_dtype_name(inputs.dtype),
                             _dtype_name(age_gender_idx.dtype)],
            "flow": type(flow).__name__,
            "platforms": [device.type],
            "output_keys": keys,
        }, f, indent=1)
    return path


def load_inference(path: str, device: DeviceLike = None
                   ) -> Tuple[Callable[..., Dict[str, Any]], dict]:
    """-> ``(infer, meta)``: ``infer(inputs, age_gender_idx) -> preds`` runs
    the exported program on ``device`` (the card unless ``"cpu"``; the
    program's constants and device arguments are moved there), the inputs
    taken as the meta's dtypes. A shape the program was not exported for
    raises."""
    from torch.export.passes import move_to_device_pass

    for name in OP_MODULES:
        importlib.import_module(f"{__package__}.ops.{name}")
    device = resolve_device(device)
    with open(path + ".json") as f:
        meta = json.load(f)
    program = move_to_device_pass(torch.export.load(path), device)
    module = program.module()
    dtypes = [getattr(torch, name) for name in meta["input_dtypes"]]

    @torch.no_grad()
    def infer(inputs, age_gender_idx):
        return module(*(torch.as_tensor(x, dtype=dtype, device=device)
                        for x, dtype in zip((inputs, age_gender_idx),
                                            dtypes)))
    return infer, meta
