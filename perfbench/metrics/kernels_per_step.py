"""``kernels_per_step`` (optimizer loop): device kernels in the traced
frames over their optimizer steps."""


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    return len(run.trace.kernels()) / run.trace.steps
