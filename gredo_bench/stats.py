"""Rate and percentile arithmetic over every task of a window."""
from __future__ import annotations

import math


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least q% of all values at or below it. A failed task enters as
    ``math.inf`` (it missed every limit)."""
    if not values:
        raise ValueError("no tasks")
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100 * len(ordered)) - 1, 0)]


def rate(completed: int, window_s: float) -> float:
    """Tasks completed per second of the whole window."""
    return completed / window_s

