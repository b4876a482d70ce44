"""Run names (``utils/naming.py``) and fault F10: the port draws the JAX
package's names from the same random stream, reserves each run's
directory when it draws the name, and two unnamed CLI runs started in the
same second get two directories."""
import json
import os
import random

from pedestrians_video_2_carla_tpu.utils import naming as J

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.utils import naming as T
from .torch_threads import limit_torch_threads

limit_torch_threads()


def test_names_are_the_jax_packages(tmp_path):
    for seed in range(5):
        assert T.random_run_name(random.Random(seed)) == \
            J.random_run_name(random.Random(seed))
    # the same stream, claimed again and again: collisions, then the
    # salted names after three of them, the same in both packages
    names = {}
    for side, module in (("port", T), ("jax", J)):
        names[side] = [module.unique_run_name(str(tmp_path / side), "x-",
                                              rng=random.Random(7))
                       for _ in range(6)]
        assert all(os.path.isdir(tmp_path / side / n) for n in names[side])
    assert names["port"] == names["jax"]
    assert len(set(names["port"])) == 6
    assert names["port"][-1].count("-") == 3          # salted


def test_unnamed_runs_in_one_second_get_two_directories(tmp_path,
                                                        monkeypatch):
    """F10: the port used to name an unnamed run by the second it started
    (``{data_module}-%Y%m%d-%H%M%S``), so two such runs shared one
    directory; with the time pinned they must not."""
    import time
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    monkeypatch.setattr(time, "strftime", lambda *a: "20231114-221320")
    argv = ["--mode=train", "--movements_model_name=LinearAE",
            "--batch_size=2", "--clip_length=3",
            "--max_epochs=1", "--limit_train_batches=1", "--val_set_size=2",
            "--loss_modes", "loc_2d_3d", "--log_every_n_steps=1",
            "--device=cpu", f"--root_dir={tmp_path}"]
    runs = [modeling.main(argv)["trainer"].log_dir for _ in range(2)]
    logs = tmp_path / "logs" / "pose_lifting"
    assert runs[0] != runs[1]
    assert sorted(os.listdir(logs)) == sorted(os.path.basename(r)
                                              for r in runs)
    for run in runs:
        assert os.path.basename(run).startswith("Carla2D3D-")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            steps = [r for r in map(json.loads, f) if "lr-movements" in r]
        assert len(steps) == 1            # each run wrote its own log alone
