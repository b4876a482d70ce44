"""Synthetic Carla2D3D data: random pose twitches on the reference skeletons,
rendered to 2D ground truth through the FK + projection pipeline.

``generate_batch`` is split in two:
  * :func:`draw_batch` makes every random draw of a batch from a
    ``torch.Generator`` on the data's device;
  * :func:`render_batch` is a deterministic function of those draws.
PyTorch and JAX give different numbers from one seed, so a test can hand
JAX's draws to :func:`render_batch` and compare the batches.
"""
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...flows.output_types import MovementsModelOutputType
from ...ops import deformation as D
from ...ops import normalization as N
from ...ops.projection import ProjectionModule, projection_state_for
from ...ops.rotations import euler_angles_to_matrix
from ...skeletons.carla import AGE_GENDER_KEYS, CARLA_SKELETON
from ..base.datamodule import BaseDataModule, batch_seed


@dataclass(frozen=True)
class Carla2D3DConfig:
    batch_size: int = 64
    clip_length: int = 30
    random_changes_each_frame: int = 3
    max_change_in_deg: float = 5.0
    max_world_rot_change_in_deg: float = 0.0
    max_initial_world_rot_change_in_deg: float = 0.0
    noise: str = "zero"
    noise_param: float = 1.0
    missing_joint_probabilities: Tuple[float, ...] = ()
    transform: str = "hips_neck"
    needs_confidence: bool = False
    val_set_size: int = 64
    test_set_size: int = 64


class BatchDraws(NamedTuple):
    """Every random draw of one batch."""
    pose_changes: torch.Tensor      # (B, L, J, 3, 3) rotation twitches
    world_rot_euler: torch.Tensor   # (B, L, 3) world yaw changes (radians)
    age_gender_idx: torch.Tensor    # (B,) int64
    crossing: torch.Tensor          # (B,) int32 synthetic binary label


def _random_pose_changes(generator: torch.Generator, cfg: Carla2D3DConfig,
                         device: torch.device) -> torch.Tensor:
    """Per-frame euler twitches on ``random_changes_each_frame`` random
    joints (chosen without replacement: the top k of uniform scores)."""
    J = len(CARLA_SKELETON)
    B, L, k = cfg.batch_size, cfg.clip_length, cfg.random_changes_each_frame
    scores = torch.rand((B, L, J), generator=generator, device=device)
    threshold = torch.sort(scores, dim=-1).values[..., J - k, None]
    chosen = scores >= threshold  # exactly k joints per (b, l)
    angles = (torch.rand((B, L, J, 3), generator=generator, device=device)
              * 2.0 - 1.0) * float(np.deg2rad(cfg.max_change_in_deg))
    angles = torch.where(chosen[..., None], angles, torch.zeros_like(angles))
    return euler_angles_to_matrix(angles, "XYZ")


def draw_batch(cfg: Carla2D3DConfig, generator: torch.Generator,
               device: torch.device) -> BatchDraws:
    """All random draws of one batch, on ``device``."""
    B, L = cfg.batch_size, cfg.clip_length
    pose_changes = _random_pose_changes(generator, cfg, device)
    world_rot_euler = torch.zeros((B, L, 3), device=device)
    if cfg.max_initial_world_rot_change_in_deg > 0:
        world_rot_euler[:, 0, 2] = (torch.rand(
            (B,), generator=generator, device=device) * 2 - 1) \
            * float(np.deg2rad(cfg.max_initial_world_rot_change_in_deg))
    if cfg.max_world_rot_change_in_deg != 0.0:
        world_rot_euler[:, 1:, 2] = (torch.rand(
            (B, L - 1), generator=generator, device=device) * 2 - 1) \
            * float(np.deg2rad(cfg.max_world_rot_change_in_deg))
    age_gender_idx = torch.randint(0, len(AGE_GENDER_KEYS), (B,),
                                   generator=generator, device=device)
    crossing = (torch.rand((B,), generator=generator, device=device)
                < 0.5).to(torch.int32)
    return BatchDraws(pose_changes, world_rot_euler, age_gender_idx, crossing)


def render_batch(cfg: Carla2D3DConfig, draws: BatchDraws,
                 generator: Optional[torch.Generator] = None):
    """One synthetic batch ``(inputs, targets, meta)`` from its draws.
    ``generator`` is used only by the input deformation (noise, missing
    joints), when the config asks for it."""
    pose_changes = draws.pose_changes
    B, L = pose_changes.shape[:2]
    world_rot_changes = euler_angles_to_matrix(draws.world_rot_euler, "XYZ")
    world_loc_changes = torch.zeros((B, L, 3), device=pose_changes.device)

    state = projection_state_for(draws.age_gender_idx)
    projection = ProjectionModule(MovementsModelOutputType.pose_changes)
    # world changes are given (not None), so generation always takes the
    # plane path, never the fused kernel
    projection_2d, outputs = projection(
        state, pose_changes, world_loc_changes, world_rot_changes)

    targets = {
        "projection_2d": projection_2d[..., :2],
        "pose_changes": pose_changes,
        "world_loc_changes": world_loc_changes,
        "world_rot_changes": world_rot_changes,
        **{k: v for k, v in outputs.items() if v is not None},
    }
    targets["crossing"] = draws.crossing

    inputs = projection_2d[..., :2]
    if cfg.noise != "zero" or cfg.missing_joint_probabilities:
        if generator is None:
            raise ValueError("input deformation needs a generator")
        probs = cfg.missing_joint_probabilities or None
        inputs = D.deform(generator, inputs, cfg.noise, cfg.noise_param, probs)
        targets["projection_2d_deformed"] = inputs

    if cfg.transform not in (None, "none"):
        normalized, _ = N.normalize_with(
            inputs, CARLA_SKELETON, extractor=cfg.transform)
        # clean targets use their own shift/scale
        clean_norm, clean_ss = N.normalize_with(
            targets["projection_2d"], CARLA_SKELETON, extractor=cfg.transform)
        targets["projection_2d_transformed"] = clean_norm[..., :2]
        targets["projection_2d_shift"] = clean_ss.shift
        targets["projection_2d_scale"] = clean_ss.scale
        inputs = normalized

    if cfg.needs_confidence:
        present = torch.any(inputs[..., :2] != 0, dim=-1, keepdim=True)
        inputs = torch.cat([inputs, present.to(inputs.dtype)], dim=-1)

    meta = {"age_gender_idx": draws.age_gender_idx}
    return inputs, targets, meta


@torch.no_grad()
def generate_batch(cfg: Carla2D3DConfig, generator: torch.Generator,
                   device: torch.device):
    """One synthetic batch ``(inputs, targets, meta)`` on ``device``."""
    return render_batch(cfg, draw_batch(cfg, generator, device), generator)


class Carla2D3DDataModule(BaseDataModule):
    """Infinite synthetic train stream + fixed-seed val/test sets, generated
    on the datamodule's device."""

    default_data_nodes = CARLA_SKELETON

    @classmethod
    def uses_infinite_train_set(cls) -> bool:
        return True

    def __init__(self, val_set_size: int = 64, test_set_size: int = 64,
                 random_changes_each_frame: int = 3,
                 max_change_in_deg: float = 5.0,
                 max_world_rot_change_in_deg: float = 0.0,
                 max_initial_world_rot_change_in_deg: float = 0.0,
                 noise: str = "zero", noise_param: float = 1.0,
                 missing_joint_probabilities=(), seed: int = 22742,
                 **kwargs) -> None:
        kwargs.setdefault("data_nodes", CARLA_SKELETON)
        super().__init__(**kwargs)
        self.seed = seed
        self._val_size = val_set_size
        self._test_size = test_set_size
        self.config = Carla2D3DConfig(
            batch_size=self.batch_size,
            clip_length=self.clip_length,
            random_changes_each_frame=random_changes_each_frame,
            max_change_in_deg=max_change_in_deg,
            max_world_rot_change_in_deg=max_world_rot_change_in_deg,
            max_initial_world_rot_change_in_deg=max_initial_world_rot_change_in_deg,
            noise=noise, noise_param=noise_param,
            missing_joint_probabilities=tuple(missing_joint_probabilities or ()),
            transform=self.transform,
            needs_confidence=self.needs_confidence,
        )

    def _batch(self, base: int, index: int):
        generator = torch.Generator(device=self.device)
        generator.manual_seed(batch_seed(base, index))
        return generate_batch(self.config, generator, self.device)

    def _batches_from(self, base: int, num_batches: int) -> Iterator:
        for i in range(num_batches):
            yield self._batch(base, i)

    def train_batches(self, seed: int = 0) -> Iterator:
        i = 0
        while True:
            yield self._batch(self.seed + 1000 + seed, i)
            i += 1

    def val_batches(self) -> Iterator:
        return self._batches_from(self.seed + 1, self.val_set_size
                                  // self.batch_size)

    def test_batches(self) -> Iterator:
        return self._batches_from(self.seed + 2, self.test_set_size
                                  // self.batch_size)

    def predict_batches(self, set_name: str) -> Iterator:
        """For ``"train"`` a finite, reproducible slice of the train stream
        (its first ``4 * val_set_size // batch_size`` batches, at least
        one: the size of the trainer's epoch guard); else the set's
        batches."""
        if set_name == "train":
            return self._batches_from(
                self.seed + 1000,
                max(1, 4 * self.val_set_size // self.batch_size))
        return super().predict_batches(set_name)

    @property
    def val_set_size(self):
        return max(1, self._val_size // self.batch_size) * self.batch_size

    @property
    def test_set_size(self):
        return max(1, self._test_size // self.batch_size) * self.batch_size

    @property
    def hparams(self):
        return {**super().hparams,
                "random_changes_each_frame": self.config.random_changes_each_frame,
                "max_change_in_deg": self.config.max_change_in_deg,
                "noise": self.config.noise,
                "missing_joint_probabilities":
                    list(self.config.missing_joint_probabilities)}
