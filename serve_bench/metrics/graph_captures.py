"""CUDA graphs the engine captured inside the window (its
``graphs.stats``): each is a shape the warm-up did not meet."""


def read(run):
    return run.counters["captures"]
