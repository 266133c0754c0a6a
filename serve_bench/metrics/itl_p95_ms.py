"""95th percentile of every gap between two consecutive tokens of a
request, pooled over all requests and gaps of the window (host clock)."""

from serve_bench.stats import percentile


def read(run):
    return percentile(run.itl_s, 95) * 1e3 if run.itl_s else None
