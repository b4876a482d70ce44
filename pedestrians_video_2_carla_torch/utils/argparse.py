"""Argparse helpers: boolean flag values, and list arguments as flat
``--foo_0 --foo_1 ...`` flags (a W&B sweep cannot sweep a list)."""
import argparse
from typing import Any, Dict, List, Optional


def boolean(v) -> bool:
    """The CLI's boolean flag values: yes/true/t/y/1, no/false/f/n/0."""
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("yes", "true", "t", "y", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Boolean value expected, got {v!r}.")


def list_arg_as_flat_args(parser, name: str, max_items: int,
                          default=None, value_type=float):
    """Registers ``--{name}_0 .. --{name}_{max_items-1}``."""
    for i in range(max_items):
        parser.add_argument(f"--{name}_{i}", type=value_type, default=default)
    return parser


def flat_args_as_list_arg(args_dict: Dict[str, Any],
                          name: str) -> Optional[List]:
    """The ``{name}_{i}`` values given, as a dense list (0 where a lower
    index is missing); None when none is."""
    items = {}
    for k, v in args_dict.items():
        if k.startswith(f"{name}_") and v is not None:
            suffix = k[len(name) + 1:]
            if suffix.isdigit():
                items[int(suffix)] = v
    if not items:
        return None
    out = [0.0] * (max(items.keys()) + 1)
    for i, v in items.items():
        out[i] = v
    return out


class DictAction(argparse.Action):
    """``--foo a=1 b=2`` -> ``{'a': 1.0, 'b': 2.0}``."""

    def __init__(self, option_strings, dest, value_type=float, **kwargs):
        self._value_type = value_type
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        out = getattr(namespace, self.dest, None) or {}
        for item in values:
            k, v = item.split("=", 1)
            out[k] = self._value_type(v)
        setattr(namespace, self.dest, out)
