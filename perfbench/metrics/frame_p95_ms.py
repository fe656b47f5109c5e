"""``frame_p95_ms``: the 95th percentile of the window's frames' latency,
from a frame's ``preprocess`` call to its ``result()`` returning; none
with fewer than ten frames beyond it."""

from perfbench import timeline


def read(run):
    return timeline.percentile([f.latency_ms for f in run.frames], 95.0)
