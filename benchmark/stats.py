"""Reductions the metrics share: percentiles over every sample, the union of
device intervals, and the spread of repeated runs."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) of every value, linear between the
    two nearest ranks (numpy's default, ``statistics.quantiles``'
    inclusive method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Overlapping and touching intervals merged; sorted."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b < a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals: Iterable[Interval], lo: float = -math.inf,
            hi: float = math.inf) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]: time in which
    at least one of them ran, however many ran at once."""
    total = 0.0
    for a, b in union(intervals):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            total += b - a
    return total


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
