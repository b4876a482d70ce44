"""Batch experiment runner: a config of ``common_params``,
``compare_params``, ``compare_model`` and ``common_model`` expands into
the cartesian product of its variants; each variant runs the port's CLI
(``python -m pedestrians_video_2_carla_torch``) as a subprocess on a
thread pool, its output captured to ``{logs_dir}/stdout/{md5(args)}.out``.

    python -m pedestrians_video_2_carla_torch.compare \\
        -c configs/compare/carla2d3d_models.yaml

``main`` reads the YAML file (PyYAML is imported there alone) and calls
``run_config`` on the parsed dict, which code without PyYAML can call
itself.
"""
import argparse
import hashlib
import itertools
import os
import subprocess
import sys
from multiprocessing.pool import ThreadPool
from typing import List, Optional


def _arg_list(variant_config: dict) -> List[str]:
    args = []
    for k, v in variant_config.items():
        if v is None:
            args.append(f"--{k}")
        elif not isinstance(v, str) and getattr(v, "__iter__", False):
            args.append(f"--{k}")
            args.extend(str(x) for x in v)
        else:
            args.append(f"--{k}={v}")
    return args


def work(variant_config: dict, logs_dir: str) -> str:
    """One variant through the CLI in a subprocess; returns the path of
    its captured output."""
    arg_list = _arg_list(variant_config)
    arg_hash = hashlib.md5(" ".join(arg_list).encode()).hexdigest()
    path = os.path.join(logs_dir, "stdout", f"{arg_hash}.out")
    with open(path, "w") as f:
        subprocess.run(
            [sys.executable, "-m", "pedestrians_video_2_carla_torch"]
            + arg_list, stdout=f, stderr=subprocess.STDOUT)
    return path


def variants_for(config: dict, root_dir: str = ".") -> List[dict]:
    """The config's variants: each model of ``compare_params`` (or the
    common one) crossed with its ``compare_model`` grid and the
    ``compare_params`` grid."""
    config = {k: dict(v) if isinstance(v, dict) else v
              for k, v in config.items()}
    if "movements_model_name" in config.get("compare_params", {}):
        models = config["compare_params"].pop("movements_model_name")
    else:
        models = [config["common_params"].pop("movements_model_name", None)]
    config.setdefault("compare_model", {})
    config.setdefault("common_model", {})

    variants = []
    for model in models:
        model_variants = config["compare_model"].get(model, {})
        common = {**config["common_params"],
                  **config["common_model"].get(model, {})}
        keys = list(model_variants.keys()) \
            + list(config.get("compare_params", {}).keys())
        for combo in itertools.product(
                *model_variants.values(),
                *config.get("compare_params", {}).values()):
            variants.append(
                {**({"movements_model_name": model} if model else {}),
                 **common, **dict(zip(keys, combo)),
                 "root_dir": root_dir})
    return variants


def logs_dir_for(config: dict, root_dir: str = ".") -> str:
    """``common_params.logs_dir`` (default ``compare_logs``), under
    ``root_dir`` unless absolute."""
    logs_dir = config["common_params"].get("logs_dir", "compare_logs")
    if not os.path.isabs(logs_dir):
        logs_dir = os.path.join(root_dir, logs_dir)
    return logs_dir


def run_config(config: dict, root_dir: str = ".",
               num_workers: int = 4) -> List[str]:
    """Every variant of a parsed config, ``num_workers`` at a time;
    returns their output files' paths."""
    logs_dir = logs_dir_for(config, root_dir)
    os.makedirs(os.path.join(logs_dir, "stdout"), exist_ok=True)
    with ThreadPool(processes=num_workers) as pool:
        return pool.starmap(work, [(variant, logs_dir) for variant in
                                   variants_for(config, root_dir)])


def main(args: Optional[List[str]] = None) -> List[str]:
    parser = argparse.ArgumentParser(
        description="Run predefined experiment variants in parallel.")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-r", "--root_dir", type=str,
                        default=os.environ.get("VIDEO2CARLA_ROOT_DIR", "."))
    parser.add_argument("-n", "--num_workers", type=int, default=4)
    parsed = parser.parse_args(args)

    import yaml

    with open(parsed.config) as f:
        config = yaml.safe_load(f)
    return run_config(config, parsed.root_dir, parsed.num_workers)


def run():
    main(sys.argv[1:])


if __name__ == "__main__":
    run()
