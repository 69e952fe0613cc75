"""Terminal logging: colours, sliding-window averages, metric tables.

The port's copy of `dro_sfm_tpu/utils/logging.py`.
"""
from __future__ import annotations

from typing import Dict, Sequence

_COLORS = {"red": 31, "green": 32, "yellow": 33, "blue": 34,
           "magenta": 35, "cyan": 36, "white": 37}


def pcolor(text: str, color: str = "white", bold: bool = False) -> str:
    """ANSI-colored text."""
    code = _COLORS.get(color, 37)
    attr = "1;" if bold else ""
    return f"\033[{attr}{code}m{text}\033[0m"


class AvgMeter:
    """Sliding-window scalar average."""

    def __init__(self, n_max: int = 100):
        self.n_max = n_max
        self.values: list[float] = []

    def __call__(self, value: float) -> float:
        self.values.append(float(value))
        if len(self.values) > self.n_max:
            self.values.pop(0)
        return self.get()

    def get(self) -> float:
        return sum(self.values) / max(len(self.values), 1)


def print_metrics_table(metrics: Dict[str, Sequence[float]],
                        metric_keys: Sequence[str],
                        title: str = "") -> None:
    """Print a table of metric rows."""
    width = 16 + 11 * len(metric_keys)
    hor = "|" + "*" * width + "|"
    print("\n" + hor)
    if title:
        print("| " + pcolor(f"{title:<{width - 2}}", "magenta", bold=True) + " |")
        print(hor)
    header = "| {:^14} ".format("METRIC") + "".join(
        "| {:^8} ".format(k[:8]) for k in metric_keys) + "|"
    print(header)
    print(hor)
    for name, vals in metrics.items():
        row = "| {:<14} ".format(name[:14]) + "".join(
            "| {:^8.3f} ".format(float(v)) for v in vals) + "|"
        print(pcolor(row, "cyan"))
    print(hor + "\n")
