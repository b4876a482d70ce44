"""The input preprocessing graph: augment -> deform (noise + missing
joints) -> normalise -> skeleton remap -> confidence, applied to whole
batches on the device of their inputs.

The JAX package jit-compiles this into one graph; here it is a chain of
eager launches. Its random draws (flip, rotation, noise, missing joints)
come from an explicit ``torch.Generator`` on the data's device, in that
order.
"""
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Type

import torch

from ..skeletons.base import Skeleton, get_common_indices
from . import augmentation as A
from . import deformation as D
from . import normalization as N
from .tensors import device_constant


@dataclass(frozen=True)
class PreprocessingConfig:
    data_nodes: Type[Skeleton]
    input_nodes: Type[Skeleton]
    transform: str = "hips_neck"              # extractor name or "none"
    noise: str = "zero"
    noise_param: float = 1.0
    missing_joint_probabilities: Tuple[float, ...] = ()
    augment_flip: float = 0.0                 # probability (0 = off)
    augment_rotate: float = 0.0               # max degrees (0 = off)
    needs_confidence: bool = False


def remap_nodes(pose: torch.Tensor, cfg: PreprocessingConfig) -> torch.Tensor:
    """data_nodes -> input_nodes gather with zero fill."""
    if cfg.data_nodes == cfg.input_nodes:
        return pose
    in_idx, data_idx = get_common_indices(cfg.data_nodes, cfg.input_nodes)
    out = pose.new_zeros(pose.shape[:-2] + (len(cfg.input_nodes),
                                            pose.shape[-1]))
    out[..., device_constant(in_idx, pose.device), :] = \
        pose[..., device_constant(data_idx, pose.device), :]
    return out


def is_deterministic(cfg: PreprocessingConfig, training: bool) -> bool:
    """Whether :func:`process_batch` draws nothing for ``cfg``: no
    augmentation in effect, no noise, no missing-joint injection."""
    if training and (cfg.augment_flip or cfg.augment_rotate):
        return False
    return cfg.noise in ("zero", None) and not cfg.missing_joint_probabilities


def process_batch(generator: Optional[torch.Generator],
                  raw_projection_2d: torch.Tensor,
                  cfg: PreprocessingConfig,
                  training: bool = False,
                  bboxes: Optional[torch.Tensor] = None,
                  clip_size: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, L, J_data, 2|3) raw detections -> (model inputs, projection
    targets).

    Targets: ``projection_2d`` (augmented clean), ``projection_2d_deformed``
    (when deforming), ``projection_2d_transformed`` + shift/scale (when
    normalising), the augmentation's ``is_flipped`` / ``rotation``; the
    per-joint ones, like the inputs, remapped to ``input_nodes``, the
    inputs with a confidence channel when ``cfg.needs_confidence``.
    ``generator`` may be None when the configuration draws nothing
    (:func:`is_deterministic`).
    """
    targets: Dict[str, torch.Tensor] = {}
    pose = raw_projection_2d

    # 1. augmentation (training only; it carries over to the ground truth)
    if training and (cfg.augment_flip or cfg.augment_rotate):
        aug = A.AugmentPose(cfg.data_nodes, flip=cfg.augment_flip or False,
                            rotate=cfg.augment_rotate or False)
        pose, bboxes, params = aug(generator, pose, bboxes=bboxes,
                                   clip_size=clip_size)
        targets["is_flipped"] = params.is_flipped
        targets["rotation"] = params.rotation
    targets["projection_2d"] = pose[..., :2]

    # 2. deformation (it does not carry over to the ground truth)
    deformed = pose
    if cfg.noise not in ("zero", None) or cfg.missing_joint_probabilities:
        deformed = D.deform(generator, pose, cfg.noise, cfg.noise_param,
                            cfg.missing_joint_probabilities or None)
        targets["projection_2d_deformed"] = deformed[..., :2]

    # 3. normalisation: the deformed inputs and the clean targets each get
    # their own shift/scale; the saved ones are the clean pose's. Joint
    # presence is read off the coordinates before it: dropped joints are
    # exact (0, 0) only until the shift/scale moves them
    inputs = deformed
    present = torch.any(deformed[..., :2] != 0, dim=-1, keepdim=True)
    if cfg.transform not in (None, "none"):
        inputs, _ = N.normalize_with(deformed, cfg.data_nodes,
                                     extractor=cfg.transform)
        clean_norm, clean_ss = N.normalize_with(pose, cfg.data_nodes,
                                                extractor=cfg.transform)
        targets["projection_2d_transformed"] = clean_norm[..., :2]
        targets["projection_2d_shift"] = clean_ss.shift
        targets["projection_2d_scale"] = clean_ss.scale

    # 4. skeleton remap of the per-joint tensors only (shift/scale are
    # (B, L, 2), which a shape test would mistake for joints whenever
    # clip_length == the joint count)
    per_joint = ("projection_2d", "projection_2d_deformed",
                 "projection_2d_transformed")
    inputs = remap_nodes(inputs, cfg)
    present = remap_nodes(present.to(inputs.dtype), cfg)
    targets = {k: remap_nodes(v, cfg) if k in per_joint else v
               for k, v in targets.items()}

    # 5. confidence channel
    if cfg.needs_confidence and inputs.shape[-1] == 2:
        inputs = torch.cat([inputs, present], dim=-1)
    elif not cfg.needs_confidence and inputs.shape[-1] > 2:
        inputs = inputs[..., :2]
    return inputs, targets
