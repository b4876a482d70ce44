"""How often a LinearAE draw trips tests/test_torch_training.py's
``test_training_step_updates_in_place_and_keeps_grads``, by its old
assertion (every parameter moved after one step) and by its new one
(every parameter has a gradient, every one whose gradient is not all zero
moved, the head moved), over seeds: the old test drew the model from
torch's global RNG (``torch.manual_seed(seed)`` here), the new one from a
seeded generator. Also counts the draws whose 6-unit bottleneck is dead on
the test's batch (B=2, L=3: all-zero first-layer gradients).

    python tools/linear_ae_dead_bottleneck.py [SEEDS]   # default 640, CPU

from the repository's root.
"""
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
    Carla2D3DDataModule  # noqa: E402
from pedestrians_video_2_carla_torch.flows.pose_lifting import \
    PoseLiftingFlow  # noqa: E402
from pedestrians_video_2_carla_torch.models.base import \
    OptimizerSettings  # noqa: E402
from pedestrians_video_2_carla_torch.models.movements.linear_ae import \
    LinearAE  # noqa: E402


def step(model, batch):
    """One training step of the test's flow: the parameters before it and
    the state after it."""
    flow = PoseLiftingFlow(model, loss_modes=["loc_2d_3d"],
                           movements_optimizer=OptimizerSettings(lr=1e-3),
                           projection_kernel="fused_train", device="cpu")
    state = flow.init_state()
    before = {k: v.detach().clone()
              for k, v in state.params["movements"].items()}
    flow.training_step(state, batch)
    return before, state.params["movements"]


def main(seeds: int = 640) -> None:
    batch = next(Carla2D3DDataModule(batch_size=2, clip_length=3,
                                     device="cpu").train_batches())
    old_fail = new_fail = dead = 0
    for seed in range(seeds):
        torch.manual_seed(seed)
        before, tree = step(LinearAE(), batch)
        old_fail += not all(v.grad is not None
                            and not torch.equal(v.detach(), before[k])
                            for k, v in tree.items())
        before, tree = step(
            LinearAE(generator=torch.Generator().manual_seed(seed)), batch)
        ok = all(v.grad is not None for v in tree.values())
        ok = ok and all(not torch.equal(v.detach(), before[k])
                        for k, v in tree.items() if v.grad.any())
        ok = ok and all(not torch.equal(tree[k].detach(), before[k])
                        for k in ("Dense_5.weight", "Dense_5.bias"))
        new_fail += not ok
        dead += not tree["Dense_0.weight"].grad.any()
    print(f"seeds {seeds}: the old assertion fails {old_fail}, the new "
          f"one {new_fail}; draws with a dead bottleneck (generator) "
          f"{dead}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
