"""``upload_ms`` (facade): host ms a traced frame spends in the program's
``ebt.upload`` spans, the events' upload and their decode on the device in
``preprocess``."""

from perfbench.metrics.filter_ms import span_ms


def read(run):
    return span_ms(run, "ebt.upload")
