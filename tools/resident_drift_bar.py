"""How far config 1's resident epoch drifts from its streamed epoch, beside
what routes known to be wrong read: ``chip_smoke.py``'s epoch-level bars
(``EPOCH_PARAM_BAR``, ``EPOCH_LOSS_BAR``) lie between the two.

On ``group_recorded``'s subsets (32 batches of 1,024 CarlaRecorded-format
clips, L=16), one epoch each of LinearAE on ``fused_train`` from one
initial state (``chip_smoke.fit_route``), against the streamed epoch
(the host AdamW):

  resident_eager     the capturable AdamW on the resident subset: sound,
                     the two AdamW forms' rounding;
  lr_x1.00001 ...    streamed, the movements lr 1.00001, 1.0001 and
                     1.001 times its value: wrong by that much;
  reshuffled         streamed over the datamodule seeded one further
                     (another batch order): wrong.

Each line: the largest |difference| of a parameter over its largest
magnitude and the largest relative difference of a logged train loss
(``chip_smoke.epoch_drift``).

    python3 tools/resident_drift_bar.py [OUT.json]

Needs one CUDA card.
"""
import json
import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

LR_SCALES = (1.00001, 1.0001, 1.001)


def lr_flow(scale):
    """chip_smoke.make_train_flow("fused_train") with the lr scaled."""
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.base import \
        OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements.linear_ae import \
        LinearAE
    import torch

    model = LinearAE(generator=torch.Generator().manual_seed(cs.SEED))
    return PoseLiftingFlow(
        model, loss_modes=["loc_2d_3d"],
        movements_optimizer=OptimizerSettings(lr=cs.LR * scale),
        projection_kernel="fused_train")


def main():
    card, _ = cs.phase_device()
    subsets = {"train": cs.recorded_clips(cs.REC_TRAIN_BATCHES * cs.BATCH,
                                          cs.SEED + 20)}
    streamed = cs.recorded_datamodule(subsets)
    resident = cs.recorded_datamodule(subsets, resident=True)
    reshuffled = cs.recorded_datamodule(subsets)
    reshuffled.seed += 1
    out = {"card": card, "steps": cs.REC_TRAIN_BATCHES,
           "bars": [cs.EPOCH_PARAM_BAR, cs.EPOCH_LOSS_BAR]}
    with tempfile.TemporaryDirectory() as tmp:
        def fit(name, route, dm, **kw):
            # a log directory of its own for each fit
            trainer, _, steps, _ = cs.fit_route(
                route, dm, os.path.join(tmp, name), validate=False, **kw)
            return trainer.state.params, steps

        ref = fit("reference", "streamed", streamed)
        routes = {"resident_eager": ("resident_eager", resident, {}),
                  "reshuffled": ("streamed", reshuffled, {})}
        for scale in LR_SCALES:
            routes[f"lr_x{scale}"] = ("streamed", streamed, {
                "make_flow": lambda scale=scale: lr_flow(scale)})
        for name, (route, dm, kw) in routes.items():
            params, steps = fit(name, route, dm, **kw)
            out[name] = dict(zip(("max_param_share", "max_loss_rel"),
                                 cs.epoch_drift(params, steps, *ref)))
            print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
