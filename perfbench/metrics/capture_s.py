"""``capture_s`` (kept programs): host seconds of ``prewarm`` and the
untimed frames that capture the kept programs, from the harness's spans."""


def read(run):
    return run.capture_s
