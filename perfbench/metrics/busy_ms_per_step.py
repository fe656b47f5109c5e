"""``busy_ms_per_step`` (objective): the union of device activity in the
traced frames' span over their optimizer steps, in ms."""


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    return run.trace.busy_s * 1e3 / run.trace.steps
