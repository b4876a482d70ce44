"""Reference torch checkpoints -> the port's parameter dicts: the port's
counterpart of the JAX package's ``models/torch_import.py``, for the
BASELINE weight-compatibility set (``LinearAE``, ``Seq2SeqEmbeddings``,
the VideoPose3D ``TemporalModel`` and PoseFormer), and a torchvision
ResNet grafted onto a pose-estimation model's backbone
(:func:`graft_resnet_backbone`).

Each importer maps a reference ``state_dict`` (numpy) onto the flax tree
the JAX package's importer builds, with the same conventions: torch Linear
``weight (out, in)`` -> ``kernel (in, out)``; torch LSTM packed i, f, g, o
gates -> per-gate kernels with ``bias_ih + bias_hh`` folded into the
h-side bias; Conv1d ``(out, in, k)`` -> ``(k, in, out)``; BatchNorm
``weight`` / ``bias`` -> ``scale`` / ``bias`` and its running statistics ->
``batch_stats``. :func:`import_torch_checkpoint` then takes that tree
through the flax bridge (``models/jax_import.py``) to the port's
``state_dict``, so a file loads into the port exactly as into the JAX
package.
"""
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .jax_import import import_flow_params


def load_torch_checkpoint(path: str, prefix: Optional[str] = None
                          ) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint (``weights_only=True``) to numpy, unwrapping
    Lightning's ``state_dict`` and an optional submodule prefix (the
    reference stores the movements model under ``movements_model.``)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = data.get("state_dict", data) if isinstance(data, dict) \
        else data
    out = {}
    for k, v in state_dict.items():
        if prefix:
            if not k.startswith(prefix):
                continue
            k = k[len(prefix):]
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)
    return out


def _linear(sd, name):
    return {"kernel": sd[f"{name}.weight"].T.copy(),
            "bias": sd[f"{name}.bias"].copy()}


def _lstm_cell(sd, prefix, layer):
    """torch nn.LSTM layer -> flax OptimizedLSTMCell params."""
    w_ih = sd[f"{prefix}.weight_ih_l{layer}"]
    w_hh = sd[f"{prefix}.weight_hh_l{layer}"]
    b = sd.get(f"{prefix}.bias_ih_l{layer}", 0) \
        + sd.get(f"{prefix}.bias_hh_l{layer}", 0)
    H = w_hh.shape[1]
    cell = {}
    for gi, g in enumerate(("i", "f", "g", "o")):
        sl = slice(gi * H, (gi + 1) * H)
        cell[f"i{g}"] = {"kernel": w_ih[sl].T.copy()}
        cell[f"h{g}"] = {"kernel": w_hh[sl].T.copy(),
                        "bias": np.asarray(b)[sl].copy()
                        if not np.isscalar(b) else np.zeros(H, np.float32)}
    return cell


def import_linear_ae(state_dict: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference ``LinearAE``: name-mangled ``_LinearAE__encoder.{0,2,4}`` +
    ``_LinearAE__decoder.{0,2,4}`` Sequential Linears -> Dense_0..Dense_5."""
    params = {}
    for part, offset in (("encoder", 0), ("decoder", 3)):
        for i, idx in enumerate((0, 2, 4)):
            params[f"Dense_{i + offset}"] = _linear(
                state_dict, f"_LinearAE__{part}.{idx}")
    return params


def import_seq2seq_embeddings(state_dict: Dict[str, np.ndarray],
                              num_layers: int = 2) -> Dict[str, Any]:
    """Reference ``Seq2SeqEmbeddings``: per-joint ``embeddings.{j}`` Linears
    + ``encoder.rnn`` / ``decoder.rnn`` stacked LSTMs + ``decoder.fc_out``."""
    joints = sorted({int(k.split(".")[1]) for k in state_dict
                     if k.startswith("embeddings.")})
    params: Dict[str, Any] = {
        "joint_embeddings": np.stack(
            [state_dict[f"embeddings.{j}.weight"].T for j in joints]),
        "joint_embeddings_bias": np.stack(
            [state_dict[f"embeddings.{j}.bias"] for j in joints])}
    for layer in range(num_layers):
        params[f"OptimizedLSTMCell_{layer}"] = _lstm_cell(
            state_dict, "encoder.rnn", layer)
    decoder: Dict[str, Any] = {
        "fc_out": _linear(state_dict, "decoder.fc_out")}
    for layer in range(num_layers):
        decoder[f"lstm_{layer}"] = _lstm_cell(state_dict, "decoder.rnn",
                                              layer)
    params["decoder"] = decoder
    return params


def import_video_pose_3d(state_dict: Dict[str, np.ndarray],
                         num_blocks: Optional[int] = None
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Public VideoPose3D ``TemporalModel``: ``expand_conv`` /
    ``expand_bn``, ``layers_conv.{2i,2i+1}`` / ``layers_bn.{2i,2i+1}``,
    ``shrink``. Returns ``(params, batch_stats)``."""
    def conv(name):
        p = {"kernel": np.transpose(state_dict[f"{name}.weight"],
                                    (2, 1, 0)).copy()}
        if f"{name}.bias" in state_dict:
            p["bias"] = state_dict[f"{name}.bias"].copy()
        return p

    def bn(name):
        return ({"scale": state_dict[f"{name}.weight"].copy(),
                 "bias": state_dict[f"{name}.bias"].copy()},
                {"mean": state_dict[f"{name}.running_mean"].copy(),
                 "var": state_dict[f"{name}.running_var"].copy()})

    if num_blocks is None:
        num_blocks = len({int(k.split(".")[1]) for k in state_dict
                          if k.startswith("layers_conv.")}) // 2
    params: Dict[str, Any] = {"expand_conv": conv("expand_conv")}
    batch_stats: Dict[str, Any] = {}
    norms = ["expand_bn"] + [f"layers_bn.{j}" for j in range(2 * num_blocks)]
    for k, name in enumerate(norms):
        params[f"BatchNorm_{k}"], batch_stats[f"BatchNorm_{k}"] = bn(name)
    for i in range(num_blocks):
        params[f"layer{i}_conv1"] = conv(f"layers_conv.{2 * i}")
        params[f"layer{i}_conv2"] = conv(f"layers_conv.{2 * i + 1}")
    shrink_w = state_dict["shrink.weight"]  # (out, in, 1)
    params["shrink"] = {
        "kernel": shrink_w[..., 0].T.copy(),
        "bias": state_dict["shrink.bias"].copy() if "shrink.bias"
        in state_dict else np.zeros(shrink_w.shape[0], np.float32)}
    return params, batch_stats


def _attention(sd, prefix):
    """timm packed-qkv attention -> the JAX PoseFormer's ``_Attention``
    (the qkv projection stays packed: a plain transpose)."""
    qkv_w = sd[f"{prefix}.qkv.weight"]       # (3D, D)
    D = qkv_w.shape[1]
    qkv_b = sd.get(f"{prefix}.qkv.bias", np.zeros(3 * D, np.float32))
    out_w = sd[f"{prefix}.proj.weight"]      # (D, D)
    out_b = sd.get(f"{prefix}.proj.bias", np.zeros(D, np.float32))
    return {"qkv": {"kernel": qkv_w.T.copy(), "bias": qkv_b.copy()},
            "proj": {"kernel": out_w.T.copy(), "bias": out_b.copy()}}


def _layer_norm(sd, name):
    return {"scale": sd[f"{name}.weight"].copy(),
            "bias": sd[f"{name}.bias"].copy()}


def import_pose_former(state_dict: Dict[str, np.ndarray],
                       depth: int = 4) -> Dict[str, Any]:
    """Public PoseFormer ``PoseTransformer``: spatial / temporal pre-norm
    blocks with packed qkv, the weighted-mean Conv1d and a LayerNorm +
    Linear head."""
    def block(prefix):
        return {
            "LayerNorm_0": _layer_norm(state_dict, f"{prefix}.norm1"),
            "_Attention_0": _attention(state_dict, f"{prefix}.attn"),
            "LayerNorm_1": _layer_norm(state_dict, f"{prefix}.norm2"),
            "_Mlp_0": {
                "Dense_0": _linear(state_dict, f"{prefix}.mlp.fc1"),
                "Dense_1": _linear(state_dict, f"{prefix}.mlp.fc2"),
            },
        }

    pos = state_dict["Spatial_pos_embed"]
    params: Dict[str, Any] = {
        "spatial_patch_embed": _linear(state_dict,
                                       "Spatial_patch_to_embedding"),
        "spatial_pos_embed": pos.reshape(1, 1, *pos.shape[-2:]).copy(),
        "temporal_pos_embed": state_dict["Temporal_pos_embed"].copy(),
        "spatial_norm": _layer_norm(state_dict, "Spatial_norm"),
        "temporal_norm": _layer_norm(state_dict, "Temporal_norm"),
        # weighted_mean is a Conv1d(num_frame, 1, 1): weight (1, rf, 1)
        "weighted_mean": state_dict["weighted_mean.weight"].reshape(-1)
        .copy(),
        "weighted_mean_bias": state_dict.get(
            "weighted_mean.bias", np.zeros(1, np.float32)).copy(),
        "head_norm": _layer_norm(state_dict, "head.0"),
        "head": _linear(state_dict, "head.1"),
    }
    for i in range(depth):
        params[f"spatial_block_{i}"] = block(f"Spatial_blocks.{i}")
        params[f"temporal_block_{i}"] = block(f"blocks.{i}")
    return params


IMPORTERS = {
    "LinearAE": import_linear_ae,
    "Seq2SeqEmbeddings": import_seq2seq_embeddings,
    "VideoPose3D": import_video_pose_3d,
    "PoseFormer": import_pose_former,
}


def graft_resnet_backbone(state_dict: Dict[str, np.ndarray],
                          params: Dict[str, torch.Tensor],
                          module_name: str = "ResNet_0"
                          ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet-50 or -101 ``state_dict`` (numpy; a
    ``layer3.10.`` key makes it a 101) grafted onto a pose-estimation
    model's parameter dict (UniPoseLSTM, P0, AvPedestrianPoseTransformer):
    returns a new dict whose ``<module_name>.*`` entries, running
    statistics included, are the torchvision ones. Where the model's
    ``conv1`` takes more channels than torchvision's 3 (UniPose's centre
    map is a 4th), the RGB slice is torchvision's and the others keep the
    model's. The other entries are ``params``' own tensors."""
    from .backbones.resnet import (RESNET50_STAGES, RESNET101_STAGES,
                                   import_torchvision_resnet)
    stages = RESNET101_STAGES if any(
        k.startswith("layer3.10.") for k in state_dict) else RESNET50_STAGES
    backbone = import_torchvision_resnet(state_dict, stages)
    prefix = f"{module_name}."
    target = params[f"{prefix}conv1.weight"]
    conv1 = backbone["conv1.weight"]
    if target.shape[1] != conv1.shape[1]:
        merged = target.detach().cpu().clone()
        merged[:, :conv1.shape[1]] = conv1
        backbone["conv1.weight"] = merged
    own = {k for k in params if k.startswith(prefix)}
    grafted = {prefix + k for k in backbone}
    if own != grafted:
        raise ValueError(
            f"the torchvision ResNet does not fit {module_name}: missing "
            f"{sorted(own - grafted)[:4]}, unexpected "
            f"{sorted(grafted - own)[:4]}")
    out = {k: v for k, v in params.items() if k not in own}
    out.update({prefix + k: v.to(params[prefix + k].device)
                for k, v in backbone.items()})
    return out


def import_torch_checkpoint(path: str, model_name: str
                            ) -> Dict[str, torch.Tensor]:
    """A reference torch or Lightning checkpoint's movements model (under
    ``movements_model.``, else the whole ``state_dict``) -> the port's
    ``state_dict`` of ``model_name`` on the CPU, VideoPose3D's running
    statistics included. A model without an importer raises."""
    if model_name not in IMPORTERS:
        raise ValueError(f"no torch weight importer for {model_name!r}; "
                         f"available: {sorted(IMPORTERS)}")
    sd = load_torch_checkpoint(path, prefix="movements_model.") \
        or load_torch_checkpoint(path)
    out = IMPORTERS[model_name](sd)
    params, batch_stats = out if isinstance(out, tuple) else (out, None)
    mutables = None if batch_stats is None \
        else {"movements": {"batch_stats": batch_stats}}
    return import_flow_params({"movements": params}, device="cpu",
                              mutables=mutables)["movements"]
