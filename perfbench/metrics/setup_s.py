"""``setup_s``: seconds from the process's start to the first timed
submission (imports, the kernels' build or load, the scene, the facade,
its prewarm captures and the untimed frames)."""


def read(run):
    return run.setup_s
