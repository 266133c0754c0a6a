"""Output tokens the engine emitted in the window over the window's seconds
(host clock)."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
