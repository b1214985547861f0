"""Statistics of a run: percentiles and interval unions."""

from __future__ import annotations

import statistics


def p90(values):
    """The 90th percentile (``statistics.quantiles``, exclusive method)."""
    values = list(values)
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=10)[8])


def merge(intervals, lo, hi):
    """Sorted disjoint (start, end) pieces of ``intervals`` within
    [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(p) for p in out]


def covered(intervals, lo, hi):
    """Length of [lo, hi] that ``intervals`` cover."""
    return sum(e - s for s, e in merge(intervals, lo, hi))


def gaps(intervals, lo, hi):
    """The pieces of [lo, hi] that ``intervals`` leave uncovered."""
    out, t = [], lo
    for s, e in merge(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_pct(intervals, lo, hi):
    return 100.0 * (1.0 - covered(intervals, lo, hi) / (hi - lo))
