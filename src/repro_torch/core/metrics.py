"""Metric helpers shared by the engine, benchmarks and tests."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def time_to_error(curve: Sequence[Tuple[float, int, float]],
                  target: float) -> Optional[Tuple[float, int]]:
    """First (time, learners) at which the validation error <= target."""
    for t, n, e in curve:
        if e <= target:
            return t, n
    return None


def common_target(curves: Sequence[Sequence[Tuple[float, int, float]]],
                  slack: float = 1.05) -> float:
    """A target error both runs reach: slack x the worse final error."""
    finals = [c[-1][2] for c in curves if c]
    return max(finals) * slack


def pct_reduction(base: float, new: float) -> float:
    """Positive = improvement (reduction) relative to baseline."""
    if base == 0:
        return 0.0
    return 100.0 * (1.0 - new / base)
