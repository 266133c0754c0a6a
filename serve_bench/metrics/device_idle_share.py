"""Share of the traced slices' wall in which no kernel, copy or set ran
on the device (device trace)."""


def read(run):
    wall = sum(s.wall_s for s in run.slices)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(s.busy_s for s in run.slices) / wall)
