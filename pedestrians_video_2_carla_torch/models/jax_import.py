"""Weight bridge: flax parameter trees (nested dicts of numpy arrays, as the
JAX package's flows hold them) -> the port's ``state_dict``s.

The mirror image of the JAX package's ``models/torch_import.py``: a flax
``Dense_i/kernel`` of shape (in, out) becomes ``Dense_i.weight`` of shape
(out, in), ``Dense_i/bias`` becomes ``Dense_i.bias``, and any other leaf
keeps its dotted path (the other layouts: :func:`flax_to_state_dict`). A
flow's ``batch_stats`` become its BatchNorm layers' running statistics
(:func:`batch_stats_to_state_dict`). A PoseFormer tree maps onto the public
PoseFormer checkpoint's names (:func:`import_pose_former`), the inverse of
the JAX package's ``models/torch_import.py::import_pose_former``.
"""
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

#: flax ``MultiHeadDotProductAttention``'s projections (``DenseGeneral``)
_ATTENTION = ("query", "key", "value", "out")


def _weight(kernel: np.ndarray, attention: Optional[str], path: str
            ) -> np.ndarray:
    """A flax kernel -> the port's ``weight``: nn.Linear's (out, in) for a
    Dense kernel (in, out) and for an attention projection's (query, key,
    value: (in, heads, head_dim); out: (heads, head_dim, out)); Conv1d's
    (out, in, width) for a temporal conv's (width, in, out)."""
    if attention == "out":
        return kernel.reshape(-1, kernel.shape[-1]).T
    if attention is not None:
        return kernel.reshape(kernel.shape[0], -1).T
    if kernel.ndim not in (2, 3):
        raise ValueError(f"{path}: no layout for a kernel of shape "
                         f"{kernel.shape}")
    return kernel.T


def flax_to_state_dict(tree: Mapping[str, Any], prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """Flatten a flax parameter tree into a PyTorch ``state_dict`` (CPU):
    ``kernel`` -> ``weight`` in nn.Linear's or Conv1d's layout
    (:func:`_weight`; an attention projection's (heads, head_dim) bias
    flattened with it), a norm's ``scale`` -> ``weight``, any other leaf
    under its dotted path."""
    out: Dict[str, torch.Tensor] = {}
    parts = prefix.rstrip(".").split(".")
    attention = parts[-1] if len(parts) > 1 and parts[-1] in _ATTENTION \
        and parts[-2].startswith("MultiHeadDotProductAttention") else None
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(flax_to_state_dict(value, prefix=f"{path}."))
            continue
        value = np.asarray(value)
        if name == "kernel":
            value, path = _weight(value, attention, path), f"{prefix}weight"
        elif name == "scale":
            path = f"{prefix}weight"
        elif name == "bias" and attention is not None:
            value = value.reshape(-1)
        out[path] = torch.from_numpy(np.array(value))
    return out


def batch_stats_to_state_dict(tree: Mapping[str, Any], prefix: str = ""
                              ) -> Dict[str, torch.Tensor]:
    """A flax ``batch_stats`` tree -> the port's BatchNorm buffers:
    ``<path>/mean`` -> ``<path>.running_mean``, ``var`` ->
    ``running_var``. Any other leaf raises."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            out.update(batch_stats_to_state_dict(value, f"{prefix}{name}."))
        elif name in ("mean", "var"):
            out[f"{prefix}running_{name}"] = torch.from_numpy(
                np.array(value))
        else:
            raise ValueError(f"{prefix}{name}: not a BatchNorm statistic")
    return out


def import_linear_ae(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``LinearAE`` tree (``Dense_0`` .. ``Dense_5``) -> the port's
    ``LinearAE`` state_dict."""
    names = sorted(flax_params, key=lambda n: int(n.split("_")[1]))
    if names != [f"Dense_{i}" for i in range(len(names))]:
        raise ValueError(f"not a LinearAE parameter tree: {sorted(flax_params)}")
    return flax_to_state_dict(flax_params)


#: a flax PoseFormer block's leaves -> the port's names under the block
_POSE_FORMER_BLOCK = {
    ("LayerNorm_0", "scale"): "norm1.weight",
    ("LayerNorm_0", "bias"): "norm1.bias",
    ("_Attention_0", "qkv", "kernel"): "attn.qkv.weight",
    ("_Attention_0", "qkv", "bias"): "attn.qkv.bias",
    ("_Attention_0", "proj", "kernel"): "attn.proj.weight",
    ("_Attention_0", "proj", "bias"): "attn.proj.bias",
    ("LayerNorm_1", "scale"): "norm2.weight",
    ("LayerNorm_1", "bias"): "norm2.bias",
    ("_Mlp_0", "Dense_0", "kernel"): "mlp.fc1.weight",
    ("_Mlp_0", "Dense_0", "bias"): "mlp.fc1.bias",
    ("_Mlp_0", "Dense_1", "kernel"): "mlp.fc2.weight",
    ("_Mlp_0", "Dense_1", "bias"): "mlp.fc2.bias",
}
#: the flax PoseFormer's other leaves -> the port's names
_POSE_FORMER_TOP = {
    ("spatial_patch_embed", "kernel"): "Spatial_patch_to_embedding.weight",
    ("spatial_patch_embed", "bias"): "Spatial_patch_to_embedding.bias",
    ("spatial_pos_embed",): "Spatial_pos_embed",
    ("spatial_norm", "scale"): "Spatial_norm.weight",
    ("spatial_norm", "bias"): "Spatial_norm.bias",
    ("temporal_pos_embed",): "Temporal_pos_embed",
    ("temporal_norm", "scale"): "Temporal_norm.weight",
    ("temporal_norm", "bias"): "Temporal_norm.bias",
    ("weighted_mean",): "weighted_mean.weight",
    ("weighted_mean_bias",): "weighted_mean.bias",
    ("head_norm", "scale"): "head.0.weight",
    ("head_norm", "bias"): "head.0.bias",
    ("head", "kernel"): "head.1.weight",
    ("head", "bias"): "head.1.bias",
}
_STAGES = {"spatial_block_": "Spatial_blocks", "temporal_block_": "blocks"}


def _leaves(tree: Mapping[str, Any], path=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (name,))
        else:
            yield path + (name,), np.asarray(value)


def _pose_former_name(path) -> str:
    for flax_prefix, port_prefix in _STAGES.items():
        index = path[0][len(flax_prefix):]
        if path[0].startswith(flax_prefix) and index.isdigit() \
                and path[1:] in _POSE_FORMER_BLOCK:
            return f"{port_prefix}.{int(index)}.{_POSE_FORMER_BLOCK[path[1:]]}"
    if path in _POSE_FORMER_TOP:
        return _POSE_FORMER_TOP[path]
    raise ValueError(f"unknown PoseFormer leaf {'/'.join(path)}")


def import_pose_former(flax_params: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """A flax ``PoseFormer`` / ``PoseFormerRot`` tree (the same tree on the
    JAX package's xla and pallas paths) -> the port's state_dict, in the
    public PoseFormer checkpoint's names. Dense kernels are transposed to
    nn.Linear weights; ``spatial_pos_embed`` (1, 1, J, emb) becomes
    (1, J, emb) and ``weighted_mean`` (rf,) the Conv1d weight (1, rf, 1).
    An unknown or a missing leaf raises."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(flax_params):
        name = _pose_former_name(path)
        if path[-1] == "kernel":
            value = value.T
        elif path == ("spatial_pos_embed",):
            value = value.reshape(value.shape[-3:])
        elif path == ("weighted_mean",):
            value = value.reshape(1, -1, 1)
        out[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    depth = sum(n.startswith("spatial_block_") for n in flax_params)
    expected = set(_POSE_FORMER_TOP.values()) | {
        f"{stage}.{i}.{leaf}" for stage in _STAGES.values()
        for i in range(depth) for leaf in _POSE_FORMER_BLOCK.values()}
    if set(out) != expected:
        raise ValueError(
            f"not a PoseFormer parameter tree: missing "
            f"{sorted(expected - set(out))}, unexpected "
            f"{sorted(set(out) - expected)}")
    return out


def import_classification(flax_params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """A flax classifier tree -> the port's state_dict. The graph-recurrent
    family's gate parameters (``rnn1_z_wx0``, ...) keep their names and
    their (in, out) shapes; Dense kernels, and the recurrent cells'
    ``i*`` / ``h*`` kernels under ``OptimizedLSTMCell_i`` / ``GRUCell_i``,
    transpose to nn.Linear weights. The same tree serves the JAX package's
    xla and pallas routes. A tree that is no classifier's raises."""
    known = ("rnn", "Dense_", "OptimizedLSTMCell_", "GRUCell_")
    unknown = [n for n in flax_params if not n.startswith(known)]
    if unknown or not any(n.startswith("Dense_") for n in flax_params):
        raise ValueError(f"not a ported classifier's parameter tree: "
                         f"{sorted(flax_params)}")
    return {k: v.to(torch.float32)
            for k, v in flax_to_state_dict(flax_params).items()}


#: the top-level names of the Seq2Seq family's flax trees
_SEQ2SEQ_TOP = ("OptimizedLSTMCell_", "decoder", "joint_embeddings",
                "joint_embeddings_bias", "Dense_")


def import_seq2seq(flax_params: Mapping[str, Any]
                   ) -> Dict[str, torch.Tensor]:
    """A flax Seq2Seq-family tree -> the port's state_dict: the encoder's
    ``OptimizedLSTMCell_{n}`` layers and the scanned decoder's one set of
    ``decoder/lstm_{layer}`` cells and ``decoder/fc_out`` (the cells'
    ``i*`` / ``h*`` kernels and the Dense kernels transposed to nn.Linear
    weights), ``joint_embeddings`` (J, 2, E) and ``joint_embeddings_bias``
    as they are (Seq2SeqEmbeddings and the Residual variants), and the
    ``Dense_i`` of Seq2SeqFlatEmbeddings. A tree with another top-level
    name, or a decoder without ``fc_out``, raises."""
    unknown = [n for n in flax_params if not n.startswith(_SEQ2SEQ_TOP)]
    decoder = flax_params.get("decoder", {})
    cells = [n for n in decoder if n.startswith("lstm_")]
    if unknown or "fc_out" not in decoder \
            or set(decoder) != set(cells) | {"fc_out"}:
        raise ValueError(f"not a Seq2Seq parameter tree: "
                         f"{sorted(flax_params)}, decoder {sorted(decoder)}")
    return flax_to_state_dict(flax_params)


def import_flow_params(flax_params: Mapping[str, Any],
                       device: DeviceLike = None,
                       mutables: Optional[Mapping[str, Any]] = None
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX flow's ``state.params`` (``{"movements": ..., "trajectory":
    ...}`` or ``{"classification": ...}``) and, where given, its
    ``state.mutables`` -> the port's flow parameter dict, on ``device`` (the
    card unless asked otherwise). A classifier's tree goes through
    :func:`import_classification`, a PoseFormer tree through
    :func:`import_pose_former`, a Seq2Seq-family tree (it has a
    ``decoder``) through :func:`import_seq2seq`, any other (LinearAE,
    VideoPose3D, the transformer, the GNNs, the trajectory models) through
    :func:`flax_to_state_dict`. A model's ``batch_stats`` join its
    parameters as running statistics (:func:`batch_stats_to_state_dict`);
    another mutable collection raises."""
    device = resolve_device(device)

    def bridge(name, tree):
        if name == "classification":
            return import_classification(tree)
        if "spatial_patch_embed" in tree:
            return import_pose_former(tree)
        if "decoder" in tree:
            return import_seq2seq(tree)
        return flax_to_state_dict(tree)
    out = {name: bridge(name, tree) for name, tree in flax_params.items()}
    for name, collections in (mutables or {}).items():
        unknown = set(collections) - {"batch_stats"}
        if unknown:
            raise ValueError(f"{name}: no port counterpart for the mutable "
                             f"collections {sorted(unknown)}")
        out[name].update(batch_stats_to_state_dict(
            collections.get("batch_stats", {})))
    return {name: {k: v.to(device) for k, v in tree.items()}
            for name, tree in out.items()}
