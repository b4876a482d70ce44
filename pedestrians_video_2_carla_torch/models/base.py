"""Movements-model output helpers."""
import torch

from ..flows.output_types import MovementsModelOutputType
from ..ops.rotations import rotation_6d_to_matrix


def movements_output_features(output_type: MovementsModelOutputType) -> int:
    """Raw per-joint feature count of each output type."""
    return {
        MovementsModelOutputType.pose_changes: 6,
        MovementsModelOutputType.relative_rot: 6,
        MovementsModelOutputType.absolute_loc: 3,
        MovementsModelOutputType.absolute_loc_rot: 9,
        MovementsModelOutputType.pose_2d: 2,
    }[output_type]


def format_movements_output(outputs: torch.Tensor,
                            output_type: MovementsModelOutputType):
    """Raw (B, L, P, x) model output -> projection-module input (6D ->
    rotation matrices)."""
    if output_type in (MovementsModelOutputType.pose_changes,
                       MovementsModelOutputType.relative_rot):
        return rotation_6d_to_matrix(outputs)
    if output_type == MovementsModelOutputType.absolute_loc_rot:
        return outputs[..., :3], rotation_6d_to_matrix(outputs[..., 3:])
    return outputs
