"""The benchmark's statistics: percentiles over all samples, spreads."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by the nearest-rank method over every
    value: the smallest value with at least q% of the values at or below
    it. An unserved request enters as its wait so far, so a stall moves
    the tail."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[k - 1])


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (Python's statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
