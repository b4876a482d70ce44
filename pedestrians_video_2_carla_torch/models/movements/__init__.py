"""Movements models (``LinearAE``, ``PoseFormer`` and ``PoseFormerRot`` so
far)."""
from .linear_ae import LinearAE
from .pose_former import PoseFormer, PoseFormerRot

MOVEMENTS_MODELS = {m.__name__: m for m in [LinearAE, PoseFormer,
                                            PoseFormerRot]}
