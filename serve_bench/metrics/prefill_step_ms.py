"""Median host wall of the window's untraced steps that admitted (ran a
prefill), their decode included."""

from serve_bench.stats import median


def read(run):
    ms = [(s.t1 - s.t0) * 1e3 for s in run.steps
          if not s.traced and s.prefill_replays]
    return median(ms) if ms else None
