"""Percentiles and spreads.  ``percentile`` is the nearest-rank method of
the program's ``workloads/metrics.py``, copied: no interpolation, so a
fixed list gives every digit again."""
from __future__ import annotations

import statistics
from typing import List, Sequence


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted list."""
    if not sorted_vals:
        return float("nan")
    rank = max(1, -(-int(q * len(sorted_vals)) // 100))  # ceil(q*n/100), >= 1
    return sorted_vals[min(rank, len(sorted_vals)) - 1]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles``, n=4)."""
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
