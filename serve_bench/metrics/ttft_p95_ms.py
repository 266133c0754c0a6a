"""95th percentile of the time to first token over every request due in
the window, from its due time to the host time at which ``step()``
returned its first token; a request still without one at the window's end
enters with its wait so far (host clock)."""

from serve_bench.stats import percentile


def read(run):
    return percentile(run.ttft_s, 95) * 1e3 if run.ttft_s else None
