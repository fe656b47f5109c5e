"""The port's kept per-frame programs (``graphs.CapturedProgram``,
``graphs.KeptSolve``, the facades' ``_programs``), on the CPU.

A CUDA graph needs the card, so the graph route runs here through the
stand-in capture of ``torch_parity.StubGraph`` (it records without running;
each replay runs the recorded Python, the first one under
``torch_parity.NoHostReads``).  With it, at 64×96 and short schedules:

* (a) the body of every captured per-frame program runs without a host
  read (the IWE cache, CMax's histograms, the event mask, both error
  pairs, FWL, the clipped IWE, the render bundle), and its replays equal
  the eager route (``graphs.eager_loops()``) bit for bit;
* (b) two frames through each facade's kept programs (CMax dense and
  translation, GML Adam, PatchEklt, PatchEkltDependent, the pyramid with
  its IWE-cache program) equal two frames of the per-call route (a fresh
  solve a frame, everything dispatched op by op) bit for bit, the error
  texts too, and capture only in the first frame;
* (c) the facade's generator is where the per-call route leaves it;
* (d) against the JAX package in float64: the CMax facade's two frames
  through its kept program within 1e-6 px, and the kept device error pair
  within 1e-6 relative of JAX's ``jit_flow_error_pair_device``;
* (e) a facade keeps one program per event capacity, a solve program
  refuses a start of another shape, a program of another signature is
  captured anew, and a replay counts its kernel launches once.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.solver.facades as jfacades
import event_based_bos_tpu.solver.programs as jprograms
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.solver.cmax as tcmax
import event_based_bos_tpu_torch.solver.facades as tfacades
import event_based_bos_tpu_torch.solver.generative as tgen
from event_based_bos_tpu_torch import data as tdata
from event_based_bos_tpu_torch import graphs, kernels
from event_based_bos_tpu_torch.solver import programs
from event_based_bos_tpu_torch.types import events_from_ndarray
from event_based_bos_tpu_torch.utils.config import propagate_config
from torch_parity import (CPU, SMALL_ROI, clear_kept_programs, same_bits,
                          small_config, small_scene, stub_capture,
                          torch_threads)

H, W = 64, 96
ROI = (SMALL_ROI["xmin"], SMALL_ROI["xmax"], SMALL_ROI["ymin"],
       SMALL_ROI["ymax"])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture
def stub(monkeypatch):
    """The graph route on the CPU through the stand-in capture; yields its
    list of captures."""
    yield stub_capture(monkeypatch)
    clear_kept_programs()


def _events(seed, dtype=torch.float32, capacity=None):
    events, _frame, _gt = small_scene(seed=seed)
    return events_from_ndarray(events.astype(np.float32), capacity=capacity,
                               device=CPU, dtype=dtype)


def _flow(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(0, scale, (2, H, W)),
                           dtype=torch.float32)


# ---------------------------------------------------------------------------
# (a) every captured body is free of host reads, and its replays are exact
# ---------------------------------------------------------------------------

def _cmax_spec(motion_model):
    return tcmax.CmaxSpec(image_size=(H, W), roi=ROI,
                          motion_model=motion_model, coarsest_patch=32,
                          finest_patch=16, n_iter=12, time_bins=4)


def _gen(**kw):
    base = dict(image_size=(H, W), iwe_sigma=2.0,
                weight_by_inverse_event_hist=True)
    base.update(kw)
    return tgen.GenerativeSpec(**base)


def _program_and_frames(name):
    """``(program, args of frame 1, args of frame 2)``."""
    x0, x1, y0, y1 = ROI
    if name in ("iwe_cache", "iwe_cache_unsigned"):
        gen = (_gen() if name == "iwe_cache" else
               _gen(no_polarity=True, weight_by_event_hist=True))
        return (tgen.iwe_cache_program(gen), (_events(0),), (_events(1),))
    if name.startswith("cmax_histograms"):
        spec = _cmax_spec("dense-flow" if name.endswith("dense")
                          else "2d-translation")
        return (tcmax.CmaxProgram(spec).histograms, (_events(0),),
                (_events(1),))
    if name == "eventmask":
        return programs.jit_eventmask((H, W)), (_events(0),), (_events(1),)
    if name == "flow_error_pair":
        def args(seed):
            return (_flow(seed)[None, :, x0:x1, y0:y1],
                    _flow(seed + 5)[None, :, x0:x1, y0:y1], _events(seed))
        return (programs.jit_flow_error_pair((H, W), ROI), args(0), args(1))
    if name == "flow_error_pair_device":
        def args(seed, sign):
            return (_events(seed), _flow(seed).double(),
                    _flow(seed + 5)[:, x0:x1, y0:y1], sign)
        return (programs.jit_flow_error_pair_device((H, W), ROI),
                args(0, 1.0), args(1, -1.0))
    if name == "fwl":
        return (programs.jit_fwl((H, W), True),
                (_events(0), _flow(0, 0.3)), (_events(1), _flow(1, 0.3)))
    if name == "fwl_device":
        return (programs.jit_fwl_device((H, W), True, torch.float64),
                (_events(0), _flow(0, 0.3), 0.5),
                (_events(1), _flow(1, 0.3), -2.0))
    if name == "clipped_iwe":
        return (programs.jit_clipped_iwe((H, W)), (_events(0), 50.0),
                (_events(1), 20.0))
    if name == "render_bundle":
        def args(seed, est_scale):
            return (_events(seed), _flow(seed), _flow(seed + 5), 50.0,
                    est_scale, 1.0 / est_scale)
        return (programs.jit_render_bundle((H, W), ROI), args(0, -1.5),
                args(1, 3.0))
    raise KeyError(name)


PROGRAMS = ["iwe_cache", "iwe_cache_unsigned", "cmax_histograms_dense",
            "cmax_histograms_translation", "eventmask", "flow_error_pair",
            "flow_error_pair_device", "fwl", "fwl_device", "clipped_iwe",
            "render_bundle"]


@pytest.mark.parametrize("name", PROGRAMS)
def test_every_program_body_is_capturable_and_exact(stub, name):
    program, frame1, frame2 = _program_and_frames(name)
    first = program(*frame1)        # eager, then the capture
    second = program(*frame2)       # the first replay, under NoHostReads
    third = program(*frame1)
    with graphs.eager_loops():
        want1, want2 = program(*frame1), program(*frame2)
    assert len(stub) == 1 and stub[0].replays == 2
    assert same_bits(first, want1) and same_bits(third, want1)
    # a replay's outputs are copies: the third call left the second's
    assert same_bits(second, want2)
    assert not same_bits(want1, want2)


def test_the_public_functions_run_the_kept_programs(stub):
    """``programs.eventmask`` and the others call their ``jit_`` program:
    the second call of a shape replays."""
    ev0, ev1 = _events(0), _events(1)
    programs.eventmask(ev0, (H, W))
    mask = programs.eventmask(ev1, (H, W))
    assert len(stub) == 1 and stub[0].replays == 1
    with graphs.eager_loops():
        assert torch.equal(mask, programs.eventmask(ev1, (H, W)))
    programs.eventmask(_events(0, capacity=8192), (H, W))
    assert len(stub) == 2  # another capacity, another capture


# ---------------------------------------------------------------------------
# (b), (c) the facades' kept programs against the per-call route
# ---------------------------------------------------------------------------

def _config(name, **solver):
    cfg = small_config(name)
    cfg["solver"].update(solver)
    propagate_config(cfg)
    return cfg


FACADES = {
    "cmax_dense": ("synthetic_cmax", {"optimizer": {"method": "Adam",
                                                    "n_iter": 12}}),
    "cmax_translation": ("synthetic_cmax", {
        "motion_model": "2d-translation",
        "optimizer": {"method": "Adam", "n_iter": 12}}),
    "gml": ("synthetic_plume", {"method": "generative_max_likelihood"}),
    "patch_eklt": ("synthetic_plume", {
        "method": "patch_eklt",
        "patch_eklt": dict(patch_size=8, sliding_window=8,
                           coarsest_patch_size=16, finest_patch_size=8),
        "generative_ml": dict(angle_model=True, poisson_model=False,
                              optimize_warp=True, iwe_sigma=2,
                              weight_loss_by_inverse_event_hist=True)}),
    "patch_eklt_dependent": ("synthetic_plume", {
        "method": "patch_eklt_dependent",
        "patch_eklt": dict(patch_size=16, sliding_window=16,
                           coarsest_patch_size=16, finest_patch_size=8)}),
    "pyramid": ("synthetic_plume", {}),
}


def _facade(cfg):
    d = cfg["data"]
    return tfacades.collections[cfg["solver"]["method"]](
        (d["height"], d["width"]), (d["crop_height"], d["crop_width"]),
        solver_config=copy.deepcopy(cfg["solver"]), visualize_module=None,
        device=CPU)


def _windows(cfg, n_frames=2):
    loader = tdata.collections["SYNTHETIC"](config=cfg["data"])
    loader.set_sequence(cfg["data"]["sequence"])
    out = []
    for i1 in range(1, 1 + n_frames):
        im1, t1 = loader.load_image(i1)
        _im2, t2 = loader.load_image(i1 + 1)
        ev = loader.load_event(max(loader.time_to_index(t1), 0),
                               min(loader.time_to_index(t2), len(loader)))
        out.append((ev, im1))
    return out


def _serve(solv, windows, captures=None):
    """Each window through the facade, with its error pair; returns the
    flows, the loss histories, the error texts' lines and the captures
    after each frame."""
    gt = np.random.default_rng(4).normal(0, 1, (2, H, W))
    flows, losses, texts, counts = [], [], [], []
    for i, (ev, frame) in enumerate(windows):
        filtered, _period = solv.preprocess(ev)
        handle = solv.estimate_async(filtered, frame=frame)
        flow = handle.result()
        if getattr(handle, "device_flow", None) is not None:
            errors = solv.flow_errors_async(filtered, gt, handle.device_flow,
                                            ROI)()
        else:
            x0, x1, y0, y1 = ROI
            errors = solv.calculate_flow_errors(
                flow[:, x0:x1, y0:y1], gt[:, x0:x1, y0:y1], filtered,
                SMALL_ROI)
        flows.append(flow)
        losses.append(getattr(handle, "loss_history", None))
        texts += [f"frame {i}::{e}" for e in errors]
        counts.append(None if captures is None else len(captures))
    return flows, losses, texts, counts


def _per_call(solv, monkeypatch):
    """The per-call route on ``solv``: a fresh solve a frame (no kept
    program), everything dispatched op by op."""
    monkeypatch.setattr(solv, "_program", lambda *a, **k: None)
    if hasattr(solv, "_cache_program"):
        monkeypatch.setattr(solv, "_cache_program", lambda capacity: None)


@pytest.mark.parametrize("name", list(FACADES))
def test_facade_programs_equal_the_per_call_route(stub, monkeypatch, name):
    cfg_name, solver = FACADES[name]
    cfg = _config(cfg_name, **solver)
    windows = _windows(cfg)
    if cfg_name == "synthetic_cmax":
        # CMax moves off flow 0 on translating dots (the plume's contrast
        # peaks there)
        windows = [(_moving_dots(2.0, -3.0, seed=0), frame)
                   for _ev, frame in windows[:1]] + [
                       (_moving_dots(-1.5, 2.5, seed=1), windows[1][1])]
    kept = _facade(cfg)
    flows, losses, texts, counts = _serve(kept, windows, stub)
    fresh = _facade(cfg)
    _per_call(fresh, monkeypatch)
    with graphs.eager_loops():
        flows_f, losses_f, texts_f, _ = _serve(fresh, windows)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(flows, flows_f))
    assert all(np.array_equal(np.signbit(a), np.signbit(b))
               for a, b in zip(flows, flows_f))
    assert same_bits(losses, losses_f)
    assert texts == texts_f
    # (c) the generator stream is the per-call route's
    assert torch.equal(kept._generator.get_state(),
                       fresh._generator.get_state())
    # every capture happens in the first frame; later frames replay
    assert counts[0] > 0 and counts[1] == counts[0], counts
    assert len(kept._programs) == 1 and all(g.replays >= 1 for g in stub)
    assert not any(np.array_equal(flows[0], f) for f in flows[1:])


def test_the_pyramid_keeps_an_iwe_cache_program_per_capacity(stub):
    cfg = _config("synthetic_plume")
    solv = _facade(cfg)
    _serve(solv, _windows(cfg))
    (capacity,) = solv._cache_programs
    program = solv._cache_programs[capacity]
    assert len(program.kept) == 1
    (call,) = program.kept.values()
    assert call.graph.replays == 1  # the second frame's


# ---------------------------------------------------------------------------
# (d) against the JAX package
# ---------------------------------------------------------------------------

def _moving_dots(vx, vy, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, n))
    x = rng.choice(np.arange(6, H - 14, 4), n) + vx * t + rng.normal(0, .1, n)
    y = rng.choice(np.arange(6, W - 14, 5), n) + vy * t + rng.normal(0, .1, n)
    return np.stack([x, y, t, np.ones(n)], 1)


def test_cmax_kept_program_matches_jax(stub):
    """Two frames of translating dots through the CMax facade's kept
    program (float64; the stencil route, which the JAX facade takes on the
    CPU) against the JAX facade: within 1e-6 px."""
    cfg = _config("synthetic_cmax")
    windows = [(_moving_dots(2.0, -3.0, seed=0), np.zeros((H, W))),
               (_moving_dots(-1.5, 2.5, seed=1), np.zeros((H, W)))]
    d = cfg["data"]
    args = ((d["height"], d["width"]), (d["crop_height"], d["crop_width"]))
    tsolv = _facade(cfg)
    tsolv.spec = dataclasses.replace(tsolv.spec, use_kernel=False)
    jsolv = jfacades.collections[cfg["solver"]["method"]](
        *args, solver_config=copy.deepcopy(cfg["solver"]),
        visualize_module=None)
    for ev, frame in windows:
        t = tsolv.estimate(tsolv.preprocess(ev)[0], frame=frame)
        j = jsolv.estimate(jsolv.preprocess(ev)[0], frame=frame)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
        assert np.abs(t).max() > 0
    assert len(tsolv._programs) == 1 and stub


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_kept_error_pair_matches_jax(stub, sign):
    x0, x1, y0, y1 = ROI
    fields = small_scene(seed=2)[0].astype(np.float32)
    jev = jtypes.events_from_ndarray(fields, capacity=4096)
    got = []
    for seed in (0, 1):  # the eager first call, then a replay
        est, gt = _flow(seed).double(), _flow(seed + 5)
        gt_c = gt[:, x0:x1, y0:y1]
        got = programs.flow_error_pair_device(
            _events(2, capacity=4096), est, gt_c, sign, (H, W), ROI)
        want = jprograms.jit_flow_error_pair_device((H, W), ROI)(
            jev, jnp.asarray(est.numpy()), jnp.asarray(gt_c.numpy()),
            jnp.float32(sign))
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                wk = float(w[k])
                assert abs(float(g[k]) - wk) <= 1e-6 * abs(wk), (k, g[k], wk)
    assert len(stub) == 1 and stub[0].replays == 1


# ---------------------------------------------------------------------------
# (e) capacities, shapes and launch accounting
# ---------------------------------------------------------------------------

def test_a_facade_keeps_a_program_per_capacity(stub):
    cfg = _config("synthetic_cmax", optimizer={"method": "Adam",
                                               "n_iter": 12})
    solv = _facade(cfg)
    dots = _moving_dots(2.0, -3.0, n=3000)
    solv.estimate(solv.preprocess(dots)[0], frame=None)
    solv.estimate(solv.preprocess(np.concatenate([dots, dots]))[0],
                  frame=None)
    assert sorted(solv._programs) == [4096, 8192]
    program = solv._programs[4096]
    with pytest.raises(ValueError, match="iterate"):
        program.solve_dense(_events(0, dtype=torch.float64),
                            init=torch.zeros((2, 3, 3), dtype=torch.float64))


def test_a_program_of_another_signature_is_captured_anew(stub):
    program = graphs.CapturedProgram(lambda x, s: x * s)
    a = program(torch.ones(3), 2.0)
    b = program(torch.ones(4), 3.0)
    c = program(torch.ones(3), 5.0)
    assert len(program.kept) == 2 and len(stub) == 2
    assert torch.equal(a, torch.full((3,), 2.0))
    assert torch.equal(b, torch.full((4,), 3.0))
    assert torch.equal(c, torch.full((3,), 5.0))
    with pytest.raises(TypeError, match="program takes"):
        program(torch.ones(3), "x")


def test_a_replay_counts_its_launches_once(monkeypatch):
    """A program that launches the vote twice: its eager first call counts
    live, the capture counts nothing, each replay adds what the capture
    recorded."""
    runs = []

    def fn(x):
        kernels.launched("hat_vote_image")
        kernels.launched("hat_vote_image")
        runs.append(1)
        return x + 1

    class Recording:
        def __init__(self, step, device):
            monkeypatch.setattr(kernels, "_capturing", lambda: True)
            try:
                step()  # what a capture records; nothing runs
            finally:
                monkeypatch.setattr(kernels, "_capturing", lambda: False)
            runs.pop()
            self.pool_bytes = 0

        def replay(self):
            runs.append(1)  # the recorded kernels run; no Python does

    monkeypatch.setattr(graphs, "graph_route", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", Recording)
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches,
                                                           0))
    program = graphs.CapturedProgram(fn)
    out = program(torch.zeros(2))
    assert kernels.launches["hat_vote_image"] == 2 and len(runs) == 1
    assert torch.equal(out, torch.ones(2))
    for _ in range(3):
        program(torch.zeros(2))
    (call,) = program.kept.values()
    assert call.launches == {"hat_vote_image": 2}
    assert kernels.launches["hat_vote_image"] == 8 and len(runs) == 4
