"""The window statistics and the trace's reduction on fixed fake
timelines."""

import math

import pytest

from perfbench import devtrace, timeline


def test_frame_ms_is_the_windows_span_over_whole_frames():
    # 3 frames submitted at 0.0, 1.0, 2.1 s; the last returns at 3.3 s
    assert timeline.frame_ms(0.0, 3.3, 3) == pytest.approx(1100.0)
    with pytest.raises(ValueError):
        timeline.frame_ms(1.0, 1.0, 3)


@pytest.mark.parametrize("n,reported", [(199, False), (200, True),
                                        (30, False)])
def test_p95_needs_ten_samples_beyond_it(n, reported):
    values = list(range(n))
    p = timeline.percentile(values, 95.0)
    assert (p is not None) == reported
    if reported:
        assert p == pytest.approx(0.95 * (n - 1))


def test_union_counts_overlaps_once_and_clips():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)]
    assert timeline.union_length(spans) == pytest.approx(3.0)
    assert timeline.union_length(spans, 0.5, 3.5) == pytest.approx(2.0)
    assert timeline.gaps(spans, -1.0, 6.0) == [(-1.0, 0.0), (2.0, 3.0),
                                               (4.0, 6.0)]


def _trace():
    A = devtrace.Activity
    device = [A("void (anonymous namespace)::hat_vote_kernel(VoteArgs, "
                "float*)", 0.0, 1.0),
              A("void (anonymous namespace)::cmax_stencil_kernel<2, "
                "true>(float const*, int)", 0.5, 2.0),
              A("Memcpy DtoH (Device -> Pinned)", 3.0, 3.5)]
    host = [A(devtrace.WINDOW, 0.0, 5.0),
            A(devtrace.PHASES[0], 2.0, 3.0), A("aten::copy_", 2.2, 2.8),
            A(devtrace.PHASES[2], 3.5, 5.0)]
    return devtrace.Trace(device, host, (0.0, 5.0), steps=4)


def test_trace_busy_idle_and_breakdown():
    t = _trace()
    assert t.busy_s == pytest.approx(2.5)
    assert [a.seconds for a in t.kernels("hat_vote_kernel")] == [1.0]
    assert len(t.kernels("cmax_stencil_kernel<2, true>")) == 1
    assert len(t.kernels()) == 2
    b = devtrace.breakdown(t)
    assert b["device_ops"][0][1] == pytest.approx(1.5)
    idle = dict(b["idle_gaps"])
    assert idle["aten::copy_"] == pytest.approx(1.0)
    assert idle[devtrace.PHASES[2]] == pytest.approx(1.5)
    assert math.isclose(sum(idle.values()), t.window_s - t.busy_s)


def test_readers_on_a_fake_trace():
    from perfbench.metrics import (busy_ms_per_step, idle_share,
                                   kernels_per_step)

    class FakeRun:
        trace = _trace()

    assert kernels_per_step.read(FakeRun) == pytest.approx(0.5)
    assert busy_ms_per_step.read(FakeRun) == pytest.approx(2500.0 / 4)
    assert idle_share.read(FakeRun) == pytest.approx(0.5)
