"""Statistics of a run's timeline: the window over whole frames, the
tail of the frames' latencies, and the union of device intervals.

Pure functions of numbers, so that the tests can hold them to fixed fake
timelines.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

#: a percentile is reported only with at least this many samples beyond it
TAIL_SAMPLES = 10


def frame_ms(opened: float, closed: float, frames: int) -> float:
    """The window's span over its frames, in ms: ``opened`` is the first
    timed submission and ``closed`` the return of the last frame's flow
    (seconds on one clock)."""
    if frames < 1 or closed <= opened:
        raise ValueError("a window needs at least one frame and a span")
    return (closed - opened) * 1e3 / frames


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics, as
    ``numpy.percentile``), or None when fewer than :data:`TAIL_SAMPLES`
    samples lie beyond it."""
    n = len(values)
    if n == 0 or n * (100.0 - q) / 100.0 < TAIL_SAMPLES:
        return None
    xs = sorted(values)
    pos = (n - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, n - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: Iterable[Tuple[float, float]],
                 lo: Optional[float] = None,
                 hi: Optional[float] = None) -> float:
    """Total length covered by ``(start, end)`` intervals, clipped to
    ``[lo, hi]`` when given; overlaps count once."""
    spans = sorted((max(s, lo) if lo is not None else s,
                    min(e, hi) if hi is not None else e)
                   for s, e in intervals)
    total = 0.0
    cur_s = cur_e = None
    for s, e in spans:
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


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of ``[lo, hi]`` that no interval covers."""
    out = []
    cur = lo
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]
