"""Order statistics and interval arithmetic of the benchmark.

The tail rule is the one the port's smoke script uses (``tail_pct``: the
highest percentile with at least ten samples beyond it), copied here so the
yardstick does not move with the program.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def tail_pct(n: int) -> int:
    """The highest percentile with at least ten of ``n`` samples beyond it
    (100, the maximum, when there are fewer than ten)."""
    return int(100 * (1 - 10 / n)) if n >= 10 else 100


def percentile(samples: Sequence[float], pct: float) -> float:
    """The ``pct`` percentile of every sample, by linear interpolation
    between the closest ranks (numpy's default rule). Raises on no sample:
    a tail of nothing is not a number."""
    if not samples:
        raise ValueError("percentile of no samples")
    xs = sorted(samples)
    pos = (len(xs) - 1) * pct / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(samples: Sequence[float]) -> float:
    return statistics.median(samples)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals, overlaps counted
    once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
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


def gaps(intervals: Iterable[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end) that no interval covers."""
    out, cursor = [], start
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if s > cursor:
            out.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        out.append((cursor, end))
    return [(s, e) for s, e in out if e > s]
