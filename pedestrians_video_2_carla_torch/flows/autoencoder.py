"""2D-pose autoencoder flow: the model's output *is* the (transformed) 2D
pose (reference ``modules/flow/autoencoder.py:19-133``); its metrics are
the MSE and two PCKs of that output, and the fit-start baseline adds the
missing-joints ratio of the inputs."""
from ..metrics.pose import PCK, MissingJointsRatio, MultiinputMSE
from .base import BaseFlow


class AutoencoderFlow(BaseFlow):
    def get_initial_metrics(self):
        return {
            "MJR": MissingJointsRatio(
                input_nodes=self.movements_model.input_nodes,
                output_nodes=self.movements_model.output_nodes),
        }

    def get_metrics(self):
        common = dict(input_nodes=self.movements_model.input_nodes,
                      output_nodes=self.movements_model.output_nodes,
                      mask_missing_joints=self.mask_missing_joints)
        return {
            "MSE": MultiinputMSE(key=self.outputs_key, **common),
            "PCKhn@01": PCK(key=self.outputs_key, threshold=0.1,
                            normalization="hn", **common),
            "PCK@005": PCK(key=self.outputs_key, threshold=0.05,
                           normalization="bbox", **common),
        }

    def _inner_step(self, params, batch, training):
        inputs, targets, meta = batch
        pose_inputs = self._apply_model(
            self.movements_model, params["movements"], inputs,
            targets if training and self.movements_model.needs_targets
            else None, training)

        es = (slice(None), self.movements_model.eval_slice)
        return {
            # the model's output lives in the normalized space when a
            # transform is on
            self.outputs_key: pose_inputs[es],
            "inputs": inputs[es],
            "targets": {k: v[es] if hasattr(v, "ndim") and v.ndim > 1 else v
                        for k, v in targets.items()},
        }
