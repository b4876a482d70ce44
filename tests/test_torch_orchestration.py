"""The port's orchestration scripts and helpers against the JAX package's,
on the CPU.

* ``compare.py``: ``variants_for`` and ``_arg_list`` of every
  ``configs/compare/*.yaml``, equal.
* ``sweep.py``: the trials of every ``configs/sweep/*.yaml`` sampler from
  the same seed and a seeded synthetic history (past the TPE's startup
  trials), ``trial_args``, and ``objective_from``; a grid sweep.
  Sampled values equal within 1e-12 (the same Python ``random`` stream).
* ``missing_joints_sensitivity.py``: the argument lists passed for every
  joint, captured by patching ``modeling_main`` in both packages, equal.
* The helpers: ``utils/{argparse,paths,printing,term,exceptions}.py`` and
  ``resolve_ckpt_path``.
* Once each for real, on the CPU at a tiny size: a 2-trial sweep, a
  sensitivity run of one joint (the joint missing from the inputs), and a
  ``compare.work`` subprocess whose output holds the CLI's metrics.
"""
import argparse
import glob
import json
import math
import os
import random

import numpy as np
import pytest
import torch
import yaml

from pedestrians_video_2_carla_tpu import compare as JCompare
from pedestrians_video_2_carla_tpu import \
    missing_joints_sensitivity as JSens
from pedestrians_video_2_carla_tpu import sweep as JSweep
from pedestrians_video_2_carla_tpu.utils import argparse as JArg
from pedestrians_video_2_carla_tpu.utils import exceptions as JExc
from pedestrians_video_2_carla_tpu.utils import paths as JPaths
from pedestrians_video_2_carla_tpu.utils import printing as JPrinting
from pedestrians_video_2_carla_tpu.utils import term as JTerm

from pedestrians_video_2_carla_torch import compare as TCompare
from pedestrians_video_2_carla_torch import \
    missing_joints_sensitivity as TSens
from pedestrians_video_2_carla_torch import sweep as TSweep
from pedestrians_video_2_carla_torch.skeletons.carla import BONE_NAMES
from pedestrians_video_2_carla_torch.utils import argparse as TArg
from pedestrians_video_2_carla_torch.utils import exceptions as TExc
from pedestrians_video_2_carla_torch.utils import paths as TPaths
from pedestrians_video_2_carla_torch.utils import printing as TPrinting
from pedestrians_video_2_carla_torch.utils import term as TTerm
from .torch_threads import limit_torch_threads

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPARE_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "compare",
                                                "*.yaml")))
SWEEP_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "sweep",
                                              "*.yaml")))
SAMPLE_TOL = 1e-12


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _name(path):
    return os.path.basename(path)[:-len(".yaml")]


# -- compare -----------------------------------------------------------------

@pytest.mark.parametrize("path", COMPARE_CONFIGS, ids=_name)
def test_compare_variants_match_jax(path):
    config = _load(path)
    got = TCompare.variants_for(config, "/runs")
    assert got == JCompare.variants_for(config, "/runs") and got
    assert [TCompare._arg_list(v) for v in got] \
        == [JCompare._arg_list(v) for v in got]
    assert config == _load(path)  # the config is left as it was
    assert TCompare.logs_dir_for(config, "/runs") == "/runs/compare_logs"


# -- sweep -------------------------------------------------------------------

def _values_close(got, want):
    assert list(got) == list(want)
    for k in got:
        if isinstance(got[k], float):
            assert got[k] == pytest.approx(want[k], abs=SAMPLE_TOL), k
        else:
            assert got[k] == want[k], k


def _trials(sampler_module, config, seed, n):
    """n trials of a config's sampler, each scored by a seeded synthetic
    objective of its parameters, the history growing as a sweep's does."""
    metric = config.get("metric", {})
    sign = -1.0 if metric.get("goal") == "minimize" else 1.0
    suggest = sampler_module.make_sampler(config, sign, seed)
    scores = random.Random(seed + 1)
    history = []
    for i in range(n):
        trial = suggest(history)
        history.append({"trial": i, "params": trial,
                        "objective": scores.random()})
    return history


@pytest.mark.parametrize("path", SWEEP_CONFIGS, ids=_name)
def test_sweep_trials_match_jax(path):
    config = _load(path)
    got = _trials(TSweep, config, 7, 9)
    want = _trials(JSweep, config, 7, 9)
    for a, b in zip(got, want):
        _values_close(a["params"], b["params"])
        extra = ["--device=cpu", "${args}"]
        assert TSweep.trial_args(a["params"], extra) \
            == JSweep.trial_args(b["params"], extra)
    tunable = [k for k, s in config["parameters"].items()
               if "value" not in s]
    assert tunable and len({json.dumps(h["params"], sort_keys=True)
                            for h in got}) > 1
    for spec in config["parameters"].values():
        if "min" in spec:
            assert all(spec["min"] <= h["params"][k] <= spec["max"]
                       for h in got for k, s in config["parameters"].items()
                       if s is spec)


def test_sweep_grid_and_objective_match_jax():
    config = {"method": "grid", "parameters": {
        "a": {"values": [1, 2]}, "b": {"value": "x"},
        "c": {"values": [0.5, 0.25]}}}
    for module in (TSweep, JSweep):
        suggest = module.make_sampler(config, 1.0, 0)
        trials = [suggest([]) for _ in range(4)]
        with pytest.raises(StopIteration):
            suggest([])
        assert trials == [{"a": a, "b": "x", "c": c}
                          for a in (1, 2) for c in (0.5, 0.25)]
    for module in (TSweep, JSweep):
        with pytest.raises(ValueError, match="grid sweeps"):
            module.grid_parameter({"min": 0, "max": 1})
    for spec in ({"value": 3}, {"values": [1, 2, 3]},
                 {"min": 1, "max": 9, "distribution": "int_uniform"},
                 {"min": 1e-4, "max": 1e-1, "distribution": "log_uniform"},
                 {"min": -1.0, "max": 1.0}):
        a, b = random.Random(5), random.Random(5)
        for _ in range(5):
            assert TSweep.sample_parameter(spec, a) == pytest.approx(
                JSweep.sample_parameter(spec, b), abs=SAMPLE_TOL)
    # objective_from: the JAX trainer's keys give the JAX function's
    # answers; the port's trainer logs val_<metric>
    for results in ({"val_metrics": {"val/PCKhn@01": 0.5}},
                    {"val_metrics": {"hp/PCKhn@01": 0.25}},
                    {"val_metrics": {"val/PCKhn@01": "x"}}, {}):
        assert TSweep.objective_from(results, "hp/PCKhn@01") \
            == JSweep.objective_from(results, "hp/PCKhn@01")
    assert TSweep.objective_from({"val_metrics": {"val_F1Score": 0.75}},
                                 "hp/F1Score") == 0.75
    assert TSweep.objective_from({"val_metrics": {"val_loss/primary": 2}},
                                 "val_loss/primary") == 2.0


def test_tpe_sampler_matches_jax_past_startup():
    params = {"lr": {"min": 0.001, "max": 1.0, "distribution": "log_uniform"},
              "units": {"values": [16, 32, 64]},
              "depth": {"min": 1, "max": 4, "distribution": "int_uniform"},
              "flow": {"value": "autoencoder"}}
    got, want = (module.TPESampler(params, -1.0, 0)
                 for module in (TSweep, JSweep))
    history = []
    for i in range(12):
        a, b = got.suggest(history), want.suggest(history)
        _values_close(a, b)
        history.append({"params": a, "objective": math.sin(i) + a["depth"]})


# -- the missing-joints sensitivity study ------------------------------------

def _captured_args(module, monkeypatch, args):
    seen = []

    def fake_main(run_args):
        seen.append(list(run_args))
        return {"val_metrics": {"val_Accuracy": 0.5 + 0.01 * len(seen),
                                "val/Accuracy": 0.5, "matrix": [1, 2]}}
    monkeypatch.setattr(module, "modeling_main", fake_main)
    return module.main(list(args)), seen


@pytest.mark.parametrize("joints", [None, ["crl_hand__L", "crl_Head__C"]],
                         ids=["all", "two"])
def test_sensitivity_arguments_match_jax(joints, monkeypatch, capsys):
    args = ["--data_module_name=Carla2D3D", "--batch_size=4"] \
        + (["--joints", *joints, "--max_epochs=1"] if joints else [])
    metrics, seen = _captured_args(TSens, monkeypatch, args)
    j_metrics, j_seen = _captured_args(JSens, monkeypatch, args)
    assert seen == j_seen
    assert len(seen) == (len(BONE_NAMES) + 1 if joints is None else 3)
    assert list(metrics) == list(j_metrics)
    assert all("matrix" not in m for m in metrics.values())
    assert "Sensitivity vs baseline" in capsys.readouterr().out


def test_sensitivity_runs_one_joint_on_the_cpu(monkeypatch, tmp_path):
    """Two real fits (the baseline and one joint missing) of a GConvGRU
    classifier; the joint is missing from the second fit's inputs."""
    from pedestrians_video_2_carla_torch import modeling

    fits = []

    def keep(run_args):
        results = modeling.main(run_args)
        fits.append(results)
        return results
    monkeypatch.setattr(TSens, "modeling_main", keep)
    metrics = TSens.main([
        "--data_module_name=Carla2D3D", "--classification_model_name=GConvGRU",
        "--hidden_size=8", "--batch_size=4", "--clip_length=4",
        "--max_epochs=1", "--limit_train_batches=2", "--val_set_size=8",
        "--device=cpu", f"--root_dir={tmp_path}", "--joints", "crl_hand__L"])
    assert list(metrics) == ["baseline", "crl_hand__L"]
    for m in metrics.values():
        assert m and all(np.isfinite(v) for v in m.values())
        assert "val_Accuracy" in m
    hand = BONE_NAMES.index("crl_hand__L")
    for results, missing in zip(fits, (False, True)):
        # the deformed points, before the inputs' normalisation
        points = next(iter(results["dm"].train_batches(0)))[1][
            "projection_2d_deformed"]
        assert bool((points[..., hand, :] == 0).all()) is missing
        assert bool((points[..., hand - 1, :] != 0).all())


# -- for real: a sweep and a compare variant ---------------------------------

TINY = {"max_epochs": {"value": 1}, "batch_size": {"value": 4},
        "clip_length": {"value": 4}, "val_set_size": {"value": 8},
        "test_set_size": {"value": 8}}


def test_sweep_runs_two_trials_on_the_cpu(tmp_path):
    config = _load(os.path.join(REPO, "configs", "sweep",
                                "carla2d3d_linear_ae.yaml"))
    config["parameters"].update(TINY)
    best, history = TSweep.run_sweep(
        config, count=2, seed=3, logs_dir=str(tmp_path / "sweeps"),
        extra_args=("--device=cpu", "--limit_train_batches=2",
                    f"--root_dir={tmp_path}"))
    assert len(history) == 2 and "error" not in history[0]
    assert all(np.isfinite(h["objective"]) for h in history)
    assert best in history
    assert history[0]["params"]["lr"] != history[1]["params"]["lr"]
    want = _trials(JSweep, config, 3, 2)
    for h, w in zip(history, want):
        _values_close(h["params"], w["params"])
    with open(tmp_path / "sweeps" / "sweep_results.jsonl") as f:
        assert [json.loads(line) for line in f] == json.loads(
            json.dumps(history))


def test_compare_work_runs_the_cli_on_the_cpu(tmp_path):
    config = _load(os.path.join(REPO, "configs", "compare",
                                "carla2d3d_models.yaml"))
    variant = TCompare.variants_for(config, str(tmp_path))[0]
    logs_dir = TCompare.logs_dir_for(config, str(tmp_path))
    # the config's logs_dir is relative to the CLI's working directory: the
    # run's logs go under tmp_path instead
    variant.update(batch_size=4, clip_length=4, max_epochs=1,
                   limit_train_batches=2, val_set_size=8, device="cpu",
                   logs_dir=logs_dir)
    os.makedirs(os.path.join(logs_dir, "stdout"))
    path = TCompare.work(variant, logs_dir)
    with open(path) as f:
        out = f.read()
    assert "val metrics:" in out and "val_MPJPE" in out, out[-2000:]
    assert glob.glob(os.path.join(logs_dir, "*", "metrics.jsonl"))


# -- the helpers -------------------------------------------------------------

def test_argparse_helpers_match_jax():
    for v in ("yes", "True", "t", "Y", "1", "no", "false", "F", "n", "0",
              True, False):
        assert TArg.boolean(v) == JArg.boolean(v)
    for module in (TArg, JArg):
        with pytest.raises(argparse.ArgumentTypeError):
            module.boolean("maybe")
    parsed = []
    for module in (TArg, JArg):
        parser = argparse.ArgumentParser()
        module.list_arg_as_flat_args(parser, "p", 4, None, float)
        parser.add_argument("--w", nargs="*", action=module.DictAction,
                            value_type=float)
        args = parser.parse_args(["--p_1", "0.5", "--p_3", "2",
                                  "--w", "a=1", "b=2.5"])
        parsed.append((module.flat_args_as_list_arg(vars(args), "p"),
                       module.flat_args_as_list_arg({"p_x": 1}, "p"),
                       args.w))
    assert parsed[0] == parsed[1] == ([0.0, 0.5, 0.0, 2.0], None,
                                      {"a": 1.0, "b": 2.5})
    from pedestrians_video_2_carla_torch import modeling
    assert modeling.boolean is TArg.boolean


def test_paths_terms_and_exceptions_match_jax(tmp_path, monkeypatch, capsys):
    for path in ("logs/pose_lifting/carla2d3d-abc123", "runs/abc9:v3/",
                 "x/LinearAE-17"):
        assert TPaths.get_run_id_from_log_dir(path) \
            == JPaths.get_run_id_from_log_dir(path)
    for path in ("logs/run1/checkpoints/last", "logs/run2/best.pt"):
        assert TPaths.get_run_id_from_checkpoint_path(path) \
            == JPaths.get_run_id_from_checkpoint_path(path)
    for t, j in ((TTerm.TERM_COLORS, JTerm.TERM_COLORS),
                 (TTerm.TERM_CONTROLS, JTerm.TERM_CONTROLS)):
        assert [(m.name, str(m)) for m in t] == [(m.name, str(m)) for m in j]
    err, j_err = (m.NotAvailableException("carla", "carla")
                  for m in (TExc, JExc))
    assert str(err) == str(j_err) and err.optional_group_name == "carla"
    # print_metrics: the JAX function ends its first value with
    # TERM_COLORS.ENDC, which its TERM_COLORS lacks; the port's ends it
    # with TERM_CONTROLS.ENDC
    with pytest.raises(AttributeError, match="ENDC"):
        JPrinting.print_metrics({"val_MPJPE": 1.5})
    capsys.readouterr()
    TPrinting.print_metrics({"val_MPJPE": 1.5, "n": 3}, header="H")
    assert capsys.readouterr().out == (
        "\033[1mH\033[0m\n  n          \033[96m3\033[0m\n"
        "  val_MPJPE  \033[96m1.5\033[0m\n")
    JPrinting.print_metrics({}, header="H")  # no value, no fault
    # resolve_ckpt_path: file:// stripped, plain paths as they are,
    # wandb:// the run's newest best archive (else the newest) by suffix
    assert TPaths.resolve_ckpt_path("file:///a/b") == "/a/b" \
        == JPaths.resolve_ckpt_path("file:///a/b")
    assert TPaths.resolve_ckpt_path("x/last") == "x/last"
    run = tmp_path / "logs" / "pose_lifting" / "run7" / "checkpoints"
    run.mkdir(parents=True)
    for i, name in enumerate(("best-step2.pt", "last.pt")):
        torch.save({}, run / name)
        os.utime(run / name, (1e9 + i, 1e9 + i))
    monkeypatch.setenv("WANDB_ARTIFACTS_DIR", str(tmp_path))
    assert TPaths.resolve_ckpt_path("wandb://e/p/run7:v2") \
        == str(run / "best-step2")
    os.remove(run / "best-step2.pt")
    assert TPaths.resolve_ckpt_path("wandb://e/p/run7") == str(run / "last")
    with pytest.raises(FileNotFoundError, match="run8"):
        TPaths.resolve_ckpt_path("wandb://e/p/run8")
