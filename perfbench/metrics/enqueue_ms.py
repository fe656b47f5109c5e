"""``enqueue_ms`` (facade layer): host ms a frame spends inside
``preprocess`` and ``estimate_async`` (filter, upload, queueing the kept
programs), from the harness's spans over the measured window."""


def read(run):
    if not run.frames:
        return None
    return sum((f.enqueued - f.submitted) for f in run.frames) * 1e3 / len(
        run.frames)
