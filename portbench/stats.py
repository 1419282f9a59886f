"""Arithmetic of the metrics: rates, tails, and busy time on a
device timeline.  Pure functions of numbers, so the tests can feed them
synthetic windows and timelines."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def rate(amounts: Sequence[float], window_s: float) -> float:
    """All the work of the window over all its time."""
    if window_s <= 0:
        raise ValueError("rate: the window has no length")
    return sum(amounts) / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile of all values (q in (0, 100])."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100.0 * len(ordered))) - 1]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(merged: Sequence[Interval], lo: float, hi: float) -> float:
    """How much of [lo, hi] the merged intervals cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def gaps(merged: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi] that the merged intervals leave bare."""
    out, at = [], lo
    for a, b in merged:
        if b <= lo or a >= hi:
            continue
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def idle_share(merged: Sequence[Interval], lo: float, hi: float) -> float:
    """The share of [lo, hi] with nothing running."""
    if hi <= lo:
        raise ValueError("idle_share: the window has no length")
    return 1.0 - covered(merged, lo, hi) / (hi - lo)
