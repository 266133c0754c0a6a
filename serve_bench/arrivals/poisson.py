"""Open loop at the cell's rate: ``rate * seconds`` arrivals whose gaps are
the exponential distribution's quantiles, scaled to fill the phase
exactly, in the mix's own order."""

import numpy as np


def due_times(mix, seconds, rate, rng):
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    gaps *= seconds / gaps.sum()  # n arrivals in exactly `seconds`
    return np.cumsum(rng.permutation(gaps))
