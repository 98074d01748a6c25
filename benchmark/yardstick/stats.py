"""Statistics of a run's samples and of a set of runs."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by nearest rank: the
    smallest value with at least ``q``% of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def spread(values) -> float:
    """The distance between the first and third quartile of ``values``,
    as Python's ``statistics.quantiles(values, n=4)`` gives them, as a
    share of their median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
