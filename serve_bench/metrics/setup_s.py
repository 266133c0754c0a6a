"""Seconds from process start to the window's start: weights, engine,
the warm-up and its graph captures (host clock)."""


def read(run):
    return run.setup_s
