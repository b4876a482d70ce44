"""Hyperparameter sweeps of W&B sweep configs (``configs/sweep/*.yaml``:
``method``, ``metric`` with ``goal`` and an ``hp/...`` name, and
``parameters``, each a ``value``, ``values`` or ``min`` / ``max`` with a
``distribution``), run locally: W&B's hosted bayes service needs the
network.

``bayes`` runs a local Tree-structured Parzen Estimator (a factorized
split of the history into good and bad trials, Bergstra et al. 2011),
``random`` seeded random search and ``grid`` a cartesian product. Each
trial is an in-process run of the port's ``modeling.main``, and its
objective the validation metric that the ``hp/<metric>`` name points to.
Results stream to ``{logs_dir}/sweep_results.jsonl``; the best trial is
printed as JSON.

    python -m pedestrians_video_2_carla_torch.sweep \\
        -c configs/sweep/carla2d3d_linear_ae.yaml --count 8

``main`` reads the YAML file (PyYAML is imported there alone) and calls
``run_sweep`` on the parsed dict, which code without PyYAML can call
itself.
"""
import argparse
import itertools
import json
import math
import os
import random
from typing import Any, Dict, List, Optional, Tuple

from .modeling import main as modeling_main


def sample_parameter(spec: Dict[str, Any], rng: random.Random) -> Any:
    if "value" in spec:
        return spec["value"]
    if "values" in spec:
        return rng.choice(spec["values"])
    dist = spec.get("distribution", "uniform")
    lo, hi = spec["min"], spec["max"]
    if dist == "int_uniform":
        return rng.randint(int(lo), int(hi))
    if dist in ("log_uniform", "log_uniform_values"):
        return math.exp(rng.uniform(math.log(lo), math.log(hi)))
    return rng.uniform(lo, hi)


def grid_parameter(spec: Dict[str, Any]) -> List[Any]:
    if "value" in spec:
        return [spec["value"]]
    if "values" in spec:
        return list(spec["values"])
    raise ValueError("grid sweeps require 'value'/'values' for every "
                     f"parameter, got {spec}")


class TPESampler:
    """A factorized Tree-structured Parzen Estimator over the sweep's
    tunable parameters: after ``N_STARTUP`` random trials the history is
    split into its best ``GAMMA`` share (good) and the rest (bad);
    candidates are drawn from the good trials' kernel density and ranked
    by the ratio of the good to the bad density, each parameter on its
    own."""

    N_STARTUP = 5
    N_CANDIDATES = 24
    GAMMA = 0.25

    def __init__(self, params: Dict[str, Any], sign: float, seed: int):
        self.params = params
        self.sign = sign  # +1 maximize, -1 minimize
        self.rng = random.Random(seed)

    def _tunable(self, spec: Dict[str, Any]) -> bool:
        return "value" not in spec and (
            "values" in spec or ("min" in spec and "max" in spec))

    @staticmethod
    def _to_latent(spec, v):
        if spec.get("distribution", "") in ("log_uniform",
                                            "log_uniform_values"):
            return math.log(max(float(v), 1e-300))
        return float(v)

    @staticmethod
    def _from_latent(spec, z):
        dist = spec.get("distribution", "uniform")
        v = math.exp(z) if dist in ("log_uniform",
                                    "log_uniform_values") else z
        v = min(max(v, spec["min"]), spec["max"])
        return int(round(v)) if dist == "int_uniform" else v

    def _numeric_suggest(self, spec, good: List, bad: List):
        lo = self._to_latent(spec, spec["min"])
        hi = self._to_latent(spec, spec["max"])
        width = max(hi - lo, 1e-12)

        def sigma(points):
            return width / max(2.0, math.sqrt(len(points) + 1) * 2.0)

        def density(x, points, s):
            p = 1.0 / width  # the uniform prior's component
            for m in points:
                p += math.exp(-0.5 * ((x - m) / s) ** 2) \
                    / (s * math.sqrt(2 * math.pi))
            return p / (len(points) + 1)

        gpts = [self._to_latent(spec, v) for v in good]
        bpts = [self._to_latent(spec, v) for v in bad]
        gsig, bsig = sigma(gpts), sigma(bpts)
        best_x, best_score = None, -math.inf
        for _ in range(self.N_CANDIDATES):
            # a draw from l(x): a good point jittered, or the prior
            if gpts and self.rng.random() > 1.0 / (len(gpts) + 1):
                x = self.rng.gauss(self.rng.choice(gpts), gsig)
                x = min(max(x, lo), hi)
            else:
                x = self.rng.uniform(lo, hi)
            score = density(x, gpts, gsig) / density(x, bpts, bsig)
            if score > best_score:
                best_x, best_score = x, score
        return self._from_latent(spec, best_x)

    def _categorical_suggest(self, spec, good: List, bad: List):
        choices = list(spec["values"])

        def probs(observed):
            # counts and a unit prior (Laplace smoothing)
            c = [1.0 + sum(1 for v in observed if v == ch) for ch in choices]
            t = sum(c)
            return [x / t for x in c]

        gp, bp = probs(good), probs(bad)
        scores = [g / b for g, b in zip(gp, bp)]
        # candidates drawn from l, the best ratio kept
        best_i, best_score = None, -math.inf
        for _ in range(self.N_CANDIDATES):
            i = self.rng.choices(range(len(choices)), weights=gp)[0]
            if scores[i] > best_score:
                best_i, best_score = i, scores[i]
        return choices[best_i]

    def suggest(self, history: List[Dict[str, Any]]) -> Dict[str, Any]:
        scored = [h for h in history if h.get("objective") is not None]
        if len(scored) < self.N_STARTUP:
            return {k: sample_parameter(v, self.rng)
                    for k, v in self.params.items()}
        scored.sort(key=lambda h: self.sign * h["objective"], reverse=True)
        n_good = max(1, int(math.ceil(self.GAMMA * len(scored))))
        good, bad = scored[:n_good], scored[n_good:] or scored[n_good - 1:]
        trial = {}
        for k, spec in self.params.items():
            if not self._tunable(spec):
                trial[k] = sample_parameter(spec, self.rng)
            elif "values" in spec:
                trial[k] = self._categorical_suggest(
                    spec, [h["params"][k] for h in good],
                    [h["params"][k] for h in bad])
            else:
                trial[k] = self._numeric_suggest(
                    spec, [h["params"][k] for h in good],
                    [h["params"][k] for h in bad])
        return trial


def make_sampler(config: Dict[str, Any], sign: float, seed: int):
    """``suggest(history) -> trial`` for the config's method."""
    params = config.get("parameters", {})
    method = config.get("method", "random")
    if method == "grid":
        keys = list(params)
        it = itertools.product(*(grid_parameter(params[k]) for k in keys))

        def grid_suggest(history):
            return dict(zip(keys, next(it)))
        return grid_suggest
    if method == "bayes":
        return TPESampler(params, sign, seed).suggest
    rng = random.Random(seed)

    def random_suggest(history):
        return {k: sample_parameter(v, rng) for k, v in params.items()}
    return random_suggest


def trial_args(trial: Dict[str, Any], extra: List[str]) -> List[str]:
    args: List[str] = []
    for k, v in trial.items():
        if isinstance(v, (list, tuple)):
            args.append(f"--{k}")
            args.extend(str(x) for x in v)
        else:
            args.append(f"--{k}={v}")
    # the literal flags of the config's 'command' (W&B's placeholders,
    # such as ${args}, dropped)
    args.extend(a for a in extra if not a.startswith("${"))
    return args


def objective_from(results: Dict[str, Any], metric_name: str
                   ) -> Optional[float]:
    """The objective in the run's validation metrics: ``hp/PCKhn@01`` is
    the port's ``val_PCKhn@01`` (the JAX package's ``val/PCKhn@01``, or the
    name as it is, where the results hold those); None where none is a
    number."""
    vm = results.get("val_metrics", {})
    keys = [metric_name]
    if metric_name.startswith("hp/"):
        name = metric_name[len("hp/"):]
        keys = [f"val_{name}", f"val/{name}", metric_name]
    v = next((vm[k] for k in keys if k in vm), None)
    return float(v) if isinstance(v, (int, float)) else None


def run_sweep(config: Dict[str, Any], count: int = 10, seed: int = 22742,
              logs_dir: str = "outputs/sweeps",
              extra_args: Tuple[str, ...] = ()
              ) -> Tuple[Optional[Dict], List]:
    """``count`` trials of a parsed sweep config (fewer where a grid runs
    out), each ``modeling.main`` of its flags, the config's literal
    ``command`` flags and ``extra_args``; a trial that raises is recorded
    with its error and the sweep goes on. Returns (the best record, every
    record)."""
    metric = config.get("metric", {"name": "hp/PCKhn@01", "goal": "maximize"})
    sign = -1.0 if metric.get("goal", "maximize") == "minimize" else 1.0
    extra = [str(a) for a in config.get("command", [])
             if isinstance(a, str) and a.startswith("--")] + list(extra_args)

    os.makedirs(logs_dir, exist_ok=True)
    results_path = os.path.join(logs_dir, "sweep_results.jsonl")

    suggest = make_sampler(config, sign, seed)
    best = None
    history = []
    for i in range(count):
        try:
            trial = suggest(history)
        except StopIteration:  # a grid ran out before count
            break
        args = trial_args(trial, extra)
        record: Dict[str, Any] = {"trial": i, "params": trial}
        try:
            results = modeling_main(args)
            value = objective_from(results, metric["name"])
            record["objective"] = value
        except Exception as e:  # a failed trial does not end the sweep
            record["error"] = repr(e)[:200]
            value = None
        history.append(record)
        with open(results_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if value is not None and (best is None
                                  or sign * value > sign * best["objective"]):
            best = record
        print(json.dumps({"trial": i, "objective": record.get("objective"),
                          "best": best["objective"] if best else None}))

    print(json.dumps({"best": best}, default=str))
    return best, history


def main(argv: Optional[List[str]] = None) -> Tuple[Optional[Dict], List]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", "-c", required=True)
    parser.add_argument("--count", type=int, default=10,
                        help="number of trials")
    parser.add_argument("--seed", type=int, default=22742)
    parser.add_argument("--logs_dir", default="outputs/sweeps")
    cli = parser.parse_args(argv)

    import yaml

    with open(cli.config) as f:
        config = yaml.safe_load(f)
    return run_sweep(config, cli.count, cli.seed, cli.logs_dir)


if __name__ == "__main__":
    main()
