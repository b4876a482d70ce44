"""Metrics printed to a terminal, bold header and coloured values."""
from typing import Any, Dict


class TERM_CONTROLS:
    BOLD = "\033[1m"
    ENDC = "\033[0m"


class TERM_COLORS:
    CYAN = "\033[96m"
    GREEN = "\033[92m"
    YELLOW = "\033[93m"
    RED = "\033[91m"


def print_metrics(metrics: Dict[str, Any], header: str = "Metrics:") -> None:
    print(f"{TERM_CONTROLS.BOLD}{header}{TERM_CONTROLS.ENDC}")
    width = max((len(k) for k in metrics), default=0)
    for k, v in sorted(metrics.items()):
        value = f"{v:.6g}" if isinstance(v, float) else str(v)
        print(f"  {k:<{width}}  {TERM_COLORS.CYAN}{value}{TERM_CONTROLS.ENDC}")
