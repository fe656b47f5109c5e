"""``filter_ms`` (facade): host ms a traced frame spends in the program's
``ebt.filter`` spans, the ROI/event filter of ``preprocess``."""

from perfbench import timeline


def span_ms(run, name):
    """Host ms a traced frame inside the program's spans ``name`` (their
    union over the traced span), or None where the trace has none."""
    if run.trace is None or not run.traced:
        return None
    spans = [(a.start, a.end) for a in run.trace.host if a.name == name]
    if not spans:
        return None
    return (timeline.union_length(spans, *run.trace.window) * 1e3
            / len(run.traced))


def read(run):
    return span_ms(run, "ebt.filter")
