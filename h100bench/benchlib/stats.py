"""Percentiles and spreads, as the benchmark's contract defines them."""

from __future__ import annotations

import math
import statistics

__all__ = ["percentile", "quartile_spread"]


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between order
    statistics (numpy's default): the tail of every sample, none left out."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, with Python's ``statistics.quantiles(n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
