"""Frozen percentile and rate arithmetic.

A percentile is taken over all samples, with linear interpolation between
the two nearest ranks (numpy's default method), and a request still
waiting at the window's end counts with its wait so far.  A rate is all
the work of the window over all of its seconds.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0..100) of all ``values``; None when
    there are none."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile {q} outside 0..100")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft_samples(due: Sequence[float], first: Sequence[Optional[float]],
                 end: float) -> List[float]:
    """Time to first token of every request due before ``end``: from its
    due time to its first token, or to ``end`` if it had none by then
    (a request still waiting, shed or failed counts as waiting)."""
    out = []
    for d, f in zip(due, first):
        if d >= end:
            continue
        out.append((f if f is not None and f <= end else end) - d)
    return out


def gaps_in_window(stamps: Sequence[float], start: float,
                   end: float) -> List[float]:
    """Gaps between consecutive delivery times whose later token falls in
    [start, end]; tokens delivered together give a gap of 0."""
    return [b - a for a, b in zip(stamps, stamps[1:]) if start <= b <= end]


def count_in_window(stamps: Iterable[float], start: float,
                    end: float) -> int:
    return sum(1 for t in stamps if start <= t <= end)


def rate(work: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate needs a window of positive length")
    return work / seconds

