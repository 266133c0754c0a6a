"""Median host wall of the window's untraced steps that decoded and
admitted nothing."""

from serve_bench.stats import median


def read(run):
    ms = [(s.t1 - s.t0) * 1e3 for s in run.steps
          if not s.traced and s.prefill_replays == 0 and s.decode_rows]
    return median(ms) if ms else None
