"""``graph_capture_s`` (kept programs): seconds the program's graph
captures took in this process, from its counter ``graph.capture_s``
(``utils/tracing.py``).  Captures happen at set-up, so this is the capture
part of ``capture_s``; a recapture later in the run would raise it."""

from event_based_bos_tpu_torch.utils import tracing


def read(run):
    # a program without counters reads nothing
    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    return counters().get("graph.capture_s")
