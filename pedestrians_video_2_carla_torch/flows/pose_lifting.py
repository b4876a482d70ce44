"""Pose-lifting flow: 2D clip -> movements model -> FK + projection -> 2D/3D
losses and the 3D pose metrics (reference
``modules/flow/pose_lifting.py:25-195``)."""
from ..metrics.fb import (FB_MPJPE, FB_MPJVE, FB_N_MPJPE, FB_PA_MPJPE,
                          FB_WeightedMPJPE)
from ..metrics.pose import MPJPE, MRPE
from ..ops import normalization as N
from ..ops.kinematics import world_from_changes
from ..ops.projection import ProjectionModule, projection_state_for
from .base import BaseFlow


class PoseLiftingFlow(BaseFlow):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.projection = ProjectionModule(
            movements_output_type=self.movements_model.output_type,
            trajectory_output_type=self.trajectory_model.output_type,
            kernel=self.projection_kernel,
        )

    def get_metrics(self):
        in_nodes = self.movements_model.input_nodes
        out_nodes = self.movements_model.output_nodes
        return {
            "MPJPE": MPJPE(input_nodes=in_nodes),
            "MRPE": MRPE(input_nodes=in_nodes, output_nodes=out_nodes),
            "FB_MPJPE": FB_MPJPE(),
            "FB_WeightedMPJPE": FB_WeightedMPJPE(),
            "FB_PA_MPJPE": FB_PA_MPJPE(),
            "FB_N_MPJPE": FB_N_MPJPE(),
            "FB_MPJVE": FB_MPJVE(),
        }

    @property
    def crucial_keys(self):
        return [self.outputs_key, "relative_pose_loc", "relative_pose_rot",
                "absolute_pose_loc", "absolute_pose_rot",
                "world_loc", "world_rot"]

    def _inner_step(self, params, batch, training):
        inputs, targets, meta = batch

        pose_inputs = self._apply_model(
            self.movements_model, params["movements"], inputs,
            targets if training and self.movements_model.needs_targets
            else None, training)
        if getattr(self.trajectory_model, "is_zero", False):
            # identity world track: skip the model call; the projection then
            # takes its identity-world route (the fused kernel, if chosen)
            world_loc_inputs = world_rot_inputs = None
        else:
            world_loc_inputs, world_rot_inputs = self._apply_model(
                self.trajectory_model, params["trajectory"], inputs,
                targets if training and self.trajectory_model.needs_targets
                else None, training)

        proj_state = projection_state_for(meta["age_gender_idx"])
        projection_2d, proj_outputs = self.projection(
            proj_state, pose_inputs, world_loc_inputs, world_rot_inputs)

        return self._slice_outputs(
            inputs, targets, pose_inputs, world_loc_inputs, world_rot_inputs,
            projection_2d, proj_outputs)

    def _slice_outputs(self, inputs, targets, pose_inputs, world_loc_inputs,
                       world_rot_inputs, projection_2d, proj_outputs):
        """Apply the movements model's eval slice and recompute the
        transformed projection."""
        es = (slice(None), self.movements_model.eval_slice)

        sliced = {}
        sliced["inputs"] = inputs[es]
        sliced["pose_inputs"] = tuple(v[es] for v in pose_inputs) \
            if isinstance(pose_inputs, tuple) else pose_inputs[es]
        sliced["projection_2d"] = projection_2d[es]
        if self.transform not in (None, "none"):
            normalized, _ = N.normalize_with(
                projection_2d[es][..., :2],
                self.movements_model.output_nodes, extractor=self.transform)
            sliced["projection_2d_transformed"] = normalized
        sliced["world_loc_inputs"] = None if world_loc_inputs is None \
            else world_loc_inputs[es]
        sliced["world_rot_inputs"] = None if world_rot_inputs is None \
            else world_rot_inputs[es]
        sliced["targets"] = {k: v[es] if hasattr(v, "ndim") and v.ndim > 1
                             else v for k, v in targets.items()}
        for k, v in proj_outputs.items():
            sliced[k] = v[es] if v is not None else None

        if targets.get("world_loc_changes") is not None:
            B, L = projection_2d.shape[:2]
            t_loc, t_rot = world_from_changes(
                (B, L), targets["world_loc_changes"],
                targets.get("world_rot_changes"))
            sliced["targets"]["world_loc"] = t_loc[es]
            sliced["targets"]["world_rot"] = t_rot[es]
        return sliced
