"""``encode_ms`` (facade): host ms a traced frame spends in the program's
``ebt.encode`` spans, the host's wire encode of the events that
``preprocess`` uploads."""

from perfbench.metrics.filter_ms import span_ms


def read(run):
    return span_ms(run, "ebt.encode")
