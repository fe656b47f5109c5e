"""The port's spans and counters (``utils/tracing.py``), on the CPU.

* without a profiler, ``span`` is one shared no-op context and cheap;
* under ``torch.profiler``, one frame of a small pyramid facade and one of
  a small CMax facade emit the program's spans, nested as the frame runs
  them, and the same frame's outputs bit for bit as without the profiler;
* every capture (a loop's step, a captured program, an L-BFGS while graph)
  adds its seconds to ``graph.capture_s`` and is an ``ebt.capture`` span;
  ``prewarm`` adds exactly its captures' seconds;
* ``trace`` raises when the profiler cannot start.
"""

import contextlib
import copy
import time

import numpy as np
import pytest
import torch

import event_based_bos_tpu_torch.solver.facades as tfacades
from event_based_bos_tpu_torch import graphs
from event_based_bos_tpu_torch import optim as topt
from event_based_bos_tpu_torch.utils import tracing
from event_based_bos_tpu_torch.utils.config import propagate_config
from torch_parity import (CPU, StubGraph, StubWhile, clear_kept_programs,
                          small_config, small_scene, stub_capture,
                          torch_threads)

#: the spans of one frame through ``preprocess``, ``estimate_async`` and
#: ``result()``
FRAME_SPANS = ("ebt.filter", "ebt.encode", "ebt.upload", "ebt.estimate",
               "ebt.loop", "ebt.fetch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture
def stub(monkeypatch):
    yield stub_capture(monkeypatch)
    clear_kept_programs()


# ---------------------------------------------------------------------------
# span and the counters
# ---------------------------------------------------------------------------

def _per_call_s(make, n=20000, repeats=5):
    """The least seconds a ``with make():`` block over ``repeats`` runs of
    ``n``."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            with make():
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    first = tracing.span("ebt.filter")
    assert first is tracing.span("ebt.loop")
    assert isinstance(first, contextlib.nullcontext)
    empty = contextlib.nullcontext()
    spanned = _per_call_s(lambda: tracing.span("ebt.loop"))
    bare = _per_call_s(lambda: empty)
    # one check and a call beyond an empty context: well under 1 µs
    assert spanned < 3.0 * bare, (spanned, bare)


def test_span_under_a_profiler_records_its_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("ebt.test"):
            torch.ones(8).add_(1.0)
    assert "ebt.test" in _spans(prof)
    assert tracing.span("ebt.test") is tracing.span("ebt.other")


def test_counters_add_up_and_are_a_copy():
    before = tracing.counters()
    tracing.count("test.events")
    tracing.count("test.events", 2)
    tracing.count("test.seconds", 0.25)
    got = tracing.counters()
    assert got["test.events"] == before.get("test.events", 0) + 3
    assert got["test.seconds"] == before.get("test.seconds", 0) + 0.25
    got["test.events"] = -1
    assert tracing.counters()["test.events"] != -1


def test_trace_raises_when_the_profiler_cannot_start(tmp_path, monkeypatch):
    def refuse(self):
        raise RuntimeError("CUPTI unavailable")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    ran = []
    with pytest.raises(RuntimeError, match="could not start"):
        with tracing.trace(str(tmp_path / "trace")):
            ran.append(1)
    assert not ran
    assert not (tmp_path / "trace").exists()


# ---------------------------------------------------------------------------
# the spans of a frame
# ---------------------------------------------------------------------------

def _spans(prof):
    """``{name: [(start, end), ...]}`` of the host ranges in ``prof``'s
    trace, in ns."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            start = ev.start_ns()
            out.setdefault(ev.name(), []).append(
                (start, start + ev.duration_ns()))
    return out


def _facade(solver):
    """A small float32 facade on the CPU (the wire's default route is
    tried at float32 only)."""
    cfg = small_config(solver)
    cfg["solver"]["precision"] = "32"
    propagate_config(cfg)
    d = cfg["data"]
    cls = tfacades.collections[cfg["solver"]["method"]]
    return cls((d["height"], d["width"]), (d["crop_height"], d["crop_width"]),
               solver_config=copy.deepcopy(cfg["solver"]),
               visualize_module=None, device=CPU)


def _frame(solver, profiled):
    """One frame of a fresh facade, with the harness's phases marked:
    ``(flow, loss histories, spans or None)``."""
    events, frame, _gt = small_scene()
    solv = _facade(solver)
    ctx = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if profiled
        else contextlib.nullcontext())
    with ctx as prof:
        with torch.profiler.record_function("test.preprocess"):
            ev, _period = solv.preprocess(events, need_t=False)
        with torch.profiler.record_function("test.enqueue"):
            handle = solv.estimate_async(ev, frame=frame)
        with torch.profiler.record_function("test.result"):
            flow = handle.result()
    losses = [h.clone() for h in handle.loss_history]
    return flow, losses, (_spans(prof) if profiled else None)


def _inside(inner, outer):
    return any(o0 <= inner[0] and inner[1] <= o1 for o0, o1 in outer)


@pytest.mark.parametrize("solver", ["synthetic_plume", "synthetic_cmax"])
def test_a_frame_emits_the_programs_spans_nested(solver):
    _flow, _losses, spans = _frame(solver, profiled=True)
    assert set(FRAME_SPANS) <= set(spans), sorted(spans)
    for name in ("ebt.filter", "ebt.encode", "ebt.upload"):
        assert all(_inside(s, spans["test.preprocess"])
                   for s in spans[name]), name
    (estimate,) = spans["ebt.estimate"]
    assert _inside(estimate, spans["test.enqueue"])
    assert spans["ebt.loop"] and all(_inside(s, [estimate])
                                     for s in spans["ebt.loop"])
    (fetch,) = spans["ebt.fetch"]
    assert _inside(fetch, spans["test.result"])
    # no capture on the CPU's eager route
    assert "ebt.capture" not in spans


@pytest.mark.parametrize("solver", ["synthetic_plume", "synthetic_cmax"])
def test_a_frame_is_the_same_with_and_without_the_profiler(solver):
    flow_a, losses_a, _ = _frame(solver, profiled=False)
    flow_b, losses_b, _ = _frame(solver, profiled=True)
    assert flow_a.dtype == flow_b.dtype
    assert np.array_equal(flow_a, flow_b)
    assert np.array_equal(np.signbit(flow_a), np.signbit(flow_b))
    assert len(losses_a) == len(losses_b)
    assert all(torch.equal(a, b) for a, b in zip(losses_a, losses_b))


# ---------------------------------------------------------------------------
# the capture counters
# ---------------------------------------------------------------------------

def _quadratic(x):
    return ((x - 1.0) ** 2).sum() + 0.1 * (x ** 4).sum()


def _capture_step(_stub):
    loop = topt.FirstOrderLoop(_quadratic, 6, method="Adam", lr=0.1)
    loop.run(torch.zeros(4, dtype=torch.float64))
    return [loop.graph.capture_ms]


def _capture_program(_stub):
    program = graphs.CapturedProgram(lambda x: x * 2.0)
    x = torch.arange(4.0)
    program(x)
    program(x + 1.0)  # a replay, no capture
    return program.capture_ms


def _capture_while(_stub):
    loop = topt.LbfgsLoop(_quadratic, 3)
    loop.run(torch.zeros(4, dtype=torch.float64))
    assert len(StubWhile.captured) == 1
    return [loop.graph.capture_ms]


@pytest.mark.parametrize("capture", [_capture_step, _capture_program,
                                     _capture_while],
                         ids=["step", "program", "while"])
def test_every_capture_counts_and_is_a_span(stub, capture):
    before = tracing.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        capture_ms = capture(stub)
    after = tracing.counters()
    assert len(capture_ms) == 1
    assert after["graph.capture_s"] - before.get("graph.capture_s", 0) == \
        pytest.approx(capture_ms[0] * 1e-3, rel=1e-9, abs=1e-12)
    assert len(_spans(prof)["ebt.capture"]) == 1


def test_prewarm_counts_exactly_its_captures(stub):
    cfg = small_config()
    cfg["solver"]["optimizer"]["n_iter"] = 24
    cfg["solver"].update(warm_start=True, steady_n_iter=12)
    propagate_config(cfg)
    d = cfg["data"]
    solv = tfacades.PatchEkltPyramid2(
        (d["height"], d["width"]), (d["crop_height"], d["crop_width"]),
        solver_config=copy.deepcopy(cfg["solver"]), visualize_module=None,
        device=CPU)
    before = tracing.counters()
    solv.prewarm(4096)
    after = tracing.counters()
    assert len(StubGraph.captured) == 5  # two scales, two schedules, cache
    capture_ms = [ms for p in solv._programs.values()
                  for ms in p.kept.capture_ms]
    capture_ms += [ms for p in solv._cache_programs.values()
                   for ms in p.capture_ms]
    assert len(capture_ms) == 5
    assert after["graph.capture_s"] - before.get("graph.capture_s", 0) == \
        pytest.approx(sum(capture_ms) * 1e-3, rel=1e-9, abs=1e-12)
