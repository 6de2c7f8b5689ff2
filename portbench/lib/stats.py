"""Arithmetic of the end-to-end metrics and of the idle share."""

from __future__ import annotations

import math
import statistics


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values: the
    smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values: list[float]) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    statistics.quantiles(n=4) gives them."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def token_times(events: list[tuple[float, int]]) -> list[float]:
    """The time of each token of a stream. The first event's tokens are
    taken at its time; an event carrying n tokens after an earlier one at
    t0 spreads them evenly over (t0, t]: a block's tokens were made one
    step after another between the two deliveries."""
    out: list[float] = []
    prev = None
    for t, n in events:
        if prev is None:
            out.extend([t] * n)
        else:
            out.extend(prev + (t - prev) * (j + 1) / n for j in range(n))
        prev = t
    return out


def tokens_in(events: list[tuple[float, int]], t0: float, t1: float) -> int:
    return sum(1 for t in token_times(events) if t0 <= t < t1)


def union_length(intervals: list[tuple[float, float]], lo: float,
                 hi: float) -> float:
    """Length of the union of the intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float
         ) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
