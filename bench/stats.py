"""Statistics of the host-clock samples: tails of all samples, rates over
whole work, and the quartile spread that sets a bound."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile of every sample (nearest rank: the smallest
    sample with at least q% of the samples at or below it)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[k - 1])


def mean(values) -> float:
    xs = list(values)
    if not xs:
        raise ValueError("no samples")
    return float(math.fsum(xs) / len(xs))


def rate(count: float, seconds: float) -> float:
    """Work over the whole time it took."""
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return float(count) / float(seconds)


def spread(values) -> float:
    """Interquartile distance as a share of the median, by
    ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
