"""``frame_ms``: the measured window's span over its frames.  The window
opens at the first timed submission and closes when the last frame
submitted before the time ran out has returned its flow."""

from perfbench import timeline


def read(run):
    return timeline.frame_ms(run.opened, run.closed, len(run.frames))
