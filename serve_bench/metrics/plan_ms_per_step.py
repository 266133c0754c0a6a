"""Host milliseconds of attention planning a decode step over the window's
untraced steps (the engine's ``plan_seconds`` over its ``decode_steps``,
as each step moved them)."""


def read(run):
    steps = [s for s in run.steps if not s.traced]
    n = sum(s.decode_steps for s in steps)
    return sum(s.plan_s for s in steps) / n * 1e3 if n else None
