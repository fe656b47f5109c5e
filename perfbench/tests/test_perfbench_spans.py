"""The readers of the program's spans and counters (``filter_ms``,
``encode_ms``, ``upload_ms``, ``launch_idle_ms``, ``graph_capture_s``) on
fake runs with hand-made host spans and device intervals."""

import pytest

from perfbench import devtrace
from perfbench.metrics import (encode_ms, filter_ms, graph_capture_s,
                               launch_idle_ms, upload_ms)

A = devtrace.Activity


class FakeRun:
    def __init__(self, device, host, window=(0.0, 10.0), frames=2):
        self.trace = devtrace.Trace(device, host, window, steps=8)
        self.traced = list(range(frames))


def _run(frames=2):
    """Two frames over 10 s: the harness's phases, the program's spans
    inside them (an upload nested in another), and device work."""
    device = [A("hat_vote_kernel", 1.0, 1.5), A("kernel", 2.0, 2.5),
              A("kernel", 3.0, 3.4), A("Memcpy DtoH", 4.5, 4.6),
              A("kernel", 6.0, 6.5), A("kernel", 7.5, 8.0)]
    host = [A(devtrace.WINDOW, 0.0, 10.0),
            A(devtrace.PHASES[0], 0.0, 1.0), A(devtrace.PHASES[0], 5.0, 6.0),
            A("ebt.filter", 0.0, 0.3), A("ebt.filter", 5.0, 5.2),
            A("ebt.encode", 0.3, 0.6), A("ebt.encode", 5.2, 5.4),
            A("ebt.upload", 0.6, 0.9), A("ebt.upload", 0.7, 0.8),
            A("ebt.upload", 5.4, 5.9),
            A(devtrace.PHASES[1], 1.0, 4.0), A("ebt.estimate", 1.0, 4.0),
            A("ebt.loop", 1.8, 3.2), A("ebt.loop", 3.1, 3.8),
            A(devtrace.PHASES[1], 6.0, 9.0), A("ebt.estimate", 6.0, 9.0),
            A("ebt.loop", 6.2, 8.5),
            A("ebt.fetch", 4.0, 4.6), A("ebt.fetch", 9.0, 9.5)]
    return FakeRun(device, host, frames=frames)


@pytest.mark.parametrize("reader,want_s", [(filter_ms, 0.3 + 0.2),
                                           (encode_ms, 0.3 + 0.2),
                                           (upload_ms, 0.3 + 0.5)],
                         ids=["filter", "encode", "upload"])
def test_span_readers_sum_their_spans_a_frame(reader, want_s):
    # the nested upload (0.7–0.8) counts once
    assert reader.read(_run()) == pytest.approx(want_s * 1e3 / 2)


def test_the_three_spans_cover_the_harness_preprocess():
    run = _run()
    total = sum(r.read(run) for r in (filter_ms, encode_ms, upload_ms))
    phase = sum(a.seconds for a in run.trace.host
                if a.name == devtrace.PHASES[0]) * 1e3 / len(run.traced)
    # 0.1 s a frame of the phase is outside the three
    assert total == pytest.approx(phase - 0.1e3)


def test_launch_idle_counts_gaps_partly_inside_the_loops():
    # device idle: 0–1, 1.5–2, 2.5–3, 3.4–4.5, 4.6–6, 6.5–7.5, 8–10;
    # the loops' union: 1.8–3.8 and 6.2–8.5
    inside = ((2.0 - 1.8) + (3.0 - 2.5) + (3.8 - 3.4) + (7.5 - 6.5)
              + (8.5 - 8.0))
    assert launch_idle_ms.read(_run()) == pytest.approx(inside * 1e3 / 2)


@pytest.mark.parametrize("reader", [filter_ms, encode_ms, upload_ms,
                                    launch_idle_ms],
                         ids=["filter", "encode", "upload", "launch_idle"])
def test_span_readers_without_frames_or_spans_give_none(reader):
    assert reader.read(_run(frames=0)) is None
    empty = _run()
    empty.trace = None
    assert reader.read(empty) is None
    # a program without the spans (the parent's): nothing to read
    bare = _run()
    bare.trace.host = [a for a in bare.trace.host
                       if not a.name.startswith("ebt.")]
    assert reader.read(bare) is None


def test_graph_capture_s_reads_the_programs_counter(monkeypatch):
    from event_based_bos_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "counters",
                        lambda: {"graph.capture_s": 1.25})
    assert graph_capture_s.read(_run()) == 1.25
    monkeypatch.setattr(tracing, "counters", lambda: {})
    assert graph_capture_s.read(_run()) is None
    # a program without counters (the parent's)
    monkeypatch.delattr(tracing, "counters")
    assert graph_capture_s.read(_run()) is None
