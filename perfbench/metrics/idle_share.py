"""``idle_share`` (device): 1 − the union of kernel, copy and memset
intervals over the traced frames' span."""


def read(run):
    if run.trace is None:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
