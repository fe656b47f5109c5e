"""The port's optimizer loops as captured steps (``graphs.py``,
``optim.FirstOrderLoop``, ``solver/pyramid.SolveProgram``), on the CPU.

A CUDA graph needs the card, so the graph route is driven here through a
stand-in capture (``torch_parity.StubGraph``): like a real capture it
records the step without running it, and each replay runs the step.  With
it:

* (a) one step of every caller of ``run_first_order`` runs under a
  dispatch mode that fails on any op that reads the host or has a
  data-dependent shape (such an op cannot be captured): the pyramid (full,
  restricted, bfloat16), CMax (dense, translation), GML, PatchEklt and the
  joint solver, each with results equal bit for bit to the eager route;
* (b) the step tables hold optax's schedule bit for bit and the
  reciprocals of its bias corrections, so the moments times them are
  within an ulp of optax's quotients, float32 and float64;
* (c) two frames through one reused solve program equal two fresh solves
  bit for bit, cold and warm, and through the facade with
  ``steady_n_iter``;
* (d) ``prewarm`` captures one program per schedule, leaves the solver's
  generator as it was and changes no later frame;
* (e) the launches a captured step makes are counted once per replay.
"""

import copy
import logging

import jax.numpy as jnp
import numpy as np
import optax
import optax.tree_utils as otu
import pytest
import torch

import event_based_bos_tpu_torch.solver.cmax as tcmax
import event_based_bos_tpu_torch.solver.facades as tfacades
import event_based_bos_tpu_torch.solver.generative as tgen
import event_based_bos_tpu_torch.solver.gml as tgml
import event_based_bos_tpu_torch.solver.patch as tpatch
import event_based_bos_tpu_torch.solver.pyramid as tpyr
from event_based_bos_tpu_torch import data as tdata
from event_based_bos_tpu_torch import graphs, kernels
from event_based_bos_tpu_torch import optim as topt
from event_based_bos_tpu_torch.types import events_from_ndarray
from event_based_bos_tpu_torch.utils.config import propagate_config
from torch_parity import (CPU, NoHostReads, clear_kept_programs,
                          same_bits, small_config, small_scene, stub_capture,
                          torch_threads)

H, W = 64, 96
ROI = (0, H, 16, 80)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture
def stub_graphs(monkeypatch):
    """The graph route on the CPU, through the stand-in capture
    (``torch_parity.StubGraph``)."""
    yield stub_capture(monkeypatch)
    clear_kept_programs()


_same = same_bits


# ---------------------------------------------------------------------------
# (a) every caller's step is capturable, and the graph route is exact
# ---------------------------------------------------------------------------

def _scene(dtype=torch.float32):
    events, frame, _gt = small_scene()
    ev = events_from_ndarray(events.astype(np.float32), device=CPU,
                             dtype=dtype)
    return ev, torch.as_tensor(frame, dtype=dtype)


def _gen(**kw):
    base = dict(image_size=(H, W), iwe_sigma=2.0,
                weight_by_inverse_event_hist=True, optimize_warp=True,
                poisson_model=True)
    base.update(kw)
    return tgen.GenerativeSpec(**base)


def _pyramid(gen=None, **kw):
    spec = tpyr.PyramidSpec(gen=gen or _gen(), roi=ROI, coarsest_patch=32,
                            finest_patch=8, n_iter=16, **kw)

    def solve():
        ev, frame = _scene()
        mask = tpyr.roi_mask(spec)
        return tpyr.estimate_frame(ev, frame, mask,
                                   torch.Generator(CPU).manual_seed(3), spec,
                                   device=CPU)
    return solve


def _cmax(motion_model):
    spec = tcmax.CmaxSpec(image_size=(H, W), roi=ROI,
                          motion_model=motion_model, coarsest_patch=32,
                          finest_patch=16, n_iter=12, time_bins=4)

    def solve():
        ev, _frame = _scene()
        return tcmax.estimate_frame_cmax(ev, None, None, spec, device=CPU)
    return solve


def _gml():
    spec = tgml.GmlSpec(gen=_gen(poisson_model=False), roi=ROI, n_iter=6)

    def solve():
        ev, frame = _scene()
        return tgml.estimate_frame_gml(ev, frame,
                                       torch.Generator(CPU).manual_seed(1),
                                       spec, device=CPU)
    return solve


def _patch(dependent):
    spec = tpatch.PatchSpec(gen=_gen(poisson_model=dependent), roi=ROI,
                            patch_size=16 if dependent else 8,
                            sliding_window=16 if dependent else 8, n_iter=6)
    est = (tpatch.estimate_frame_dependent if dependent
           else tpatch.estimate_frame_patch)

    def solve():
        ev, frame = _scene()
        return est(ev, frame, torch.Generator(CPU).manual_seed(2), spec,
                   device=CPU)
    return solve


CALLERS = {
    "pyramid": _pyramid(),
    "pyramid_restricted": _pyramid(restrict_to_roi=True, roi_norm_stride=4),
    "pyramid_bfloat16": _pyramid(_gen(compute_dtype=torch.bfloat16)),
    "cmax_dense": _cmax("dense-flow"),
    "cmax_translation": _cmax("2d-translation"),
    "gml": _gml(),
    "patch_eklt": _patch(False),
    "patch_eklt_dependent": _patch(True),
}


@pytest.mark.parametrize("caller", list(CALLERS))
def test_every_callers_step_is_capturable_and_exact(stub_graphs, caller,
                                                    monkeypatch):
    solve = CALLERS[caller]
    got = solve()
    assert stub_graphs and all(g.replays >= 1 for g in stub_graphs)
    monkeypatch.setattr(graphs, "graph_route", lambda device: False)
    want = solve()
    assert _same(got, want)


def test_the_checking_mode_catches_host_reads():
    x = torch.arange(4.0)
    with NoHostReads():
        with pytest.raises(AssertionError, match="captured"):
            float(x.sum())
        with pytest.raises(AssertionError, match="boolean"):
            x[x > 1]
        y = torch.where(x > 1, x, 0.0)
    assert torch.equal(y, torch.tensor([0.0, 0.0, 2.0, 3.0]))


# ---------------------------------------------------------------------------
# (b) the step tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("method", ["Adam", "NAdam", "Adamax", "RAdam",
                                    "SGD"])
def test_step_tables_match_optax(method, dtype):
    tdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    n, lr, step, decay = 40, 0.05, 7, 0.5
    opt = topt.make_optimizer(method, lr, step, decay)
    table = opt.step_table(n, tdt, CPU)
    schedule = optax.exponential_decay(lr, step, decay, staircase=True)
    want_lr = np.asarray([schedule(jnp.int32(c)) for c in range(n)],
                         np.float32)
    assert np.array_equal(-table[:, 0].numpy(), want_lr.astype(dtype))
    m = np.random.default_rng(0).normal(size=n).astype(dtype)

    def within_ulps(a, b, k):
        return bool(np.all(np.abs(a - b) <= k * np.spacing(np.abs(b))))

    def corrected(decay, count, col):
        """The column holds ``1 / (1 − decay^count)`` computed in float64
        and rounded to ``dtype`` (what dividing by the Python number does
        on the card); the moments times it are within two ulps of optax's
        quotient (an ulp from the reciprocal, one from XLA's float64
        power, which may differ from Python's in the last bit)."""
        counts = [count(c) for c in range(n)]
        inv = torch.as_tensor([1 / (1 - decay ** k) for k in counts],
                              dtype=torch.float64).to(tdt)
        want = np.asarray([otu.tree_bias_correction(jnp.asarray(m[c]), decay,
                                                    jnp.int32(counts[c]))
                           for c in range(n)])
        got = (torch.as_tensor(m) * table[:, col]).numpy()
        return torch.equal(table[:, col], inv) and within_ulps(got, want, 2)

    b1, b2 = opt.b1, opt.b2
    cols = {"Adam": [(b1, 1, 1), (b2, 1, 2)],
            "NAdam": [(b1, 2, 1), (b1, 1, 2), (b2, 1, 3)],
            "Adamax": [(b1, 1, 1)],
            "RAdam": [(b1, 1, 1), (b2, 1, 2)],
            "SGD": []}[method]
    assert table.shape == (n, 1 + len(opt.scalars(0)))
    for d, ahead, col in cols:
        assert corrected(d, lambda c: c + ahead, col), (d, ahead, col)
    if method == "RAdam":
        # rectified from the step where optax's ro reaches the threshold
        c = np.arange(1, n + 1)
        b2t = b2 ** c
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = ro_inf - 2 * c * b2t / (1 - b2t)
        assert np.array_equal(table[:, 4].numpy() != 0, ro >= 5.0)


# ---------------------------------------------------------------------------
# (c) solve programs reused frame after frame
# ---------------------------------------------------------------------------

def _frame_constants(seed, spec):
    events, frame, _gt = small_scene(seed=seed)
    ev = events_from_ndarray(events.astype(np.float32), device=CPU)
    gx, gy, hist, weights, wi = tgen.frame_constants(
        ev, torch.as_tensor(frame), spec.gen, CPU)[1:]
    mask = torch.as_tensor(tpyr.roi_mask(spec))
    return hist, weights, wi, gx, gy, mask


@pytest.mark.parametrize("warm", [False, True])
def test_a_reused_program_equals_fresh_solves(stub_graphs, warm):
    spec = tpyr.PyramidSpec(gen=_gen(), roi=ROI, coarsest_patch=32,
                            finest_patch=8, n_iter=16, record_evolution=3)
    program = tpyr.SolveProgram(spec)
    frames = [_frame_constants(seed, spec) for seed in (0, 1)]

    def run(make_program):
        gen = torch.Generator(CPU).manual_seed(5)
        out, prev = [], None
        for consts in frames:
            flow, aux = tpyr.solve_pyramid(*consts, gen, spec,
                                           prev_params=prev,
                                           program=make_program())
            out.append((flow, aux))
            if warm:
                prev = tpyr.update_coarse_from_fine(aux["params_per_scale"],
                                                    spec)
        return out

    reused = run(lambda: program)
    assert len(stub_graphs) == 3  # one capture a scale, at the first frame
    fresh = run(lambda: None)
    assert _same(reused, fresh)
    # the first frame's outputs are copies: the second frame left them
    assert not _same(reused[0][1]["loss_history"],
                     reused[1][1]["loss_history"])


def _facade_config(**solver):
    """The small pyramid config at 24 iterations: every scale of both
    schedules (8 + 12, and 4 + 6 with ``steady_n_iter: 12``) runs long
    enough to be captured."""
    cfg = small_config()
    cfg["solver"]["optimizer"]["n_iter"] = 24
    cfg["solver"].update(solver)
    propagate_config(cfg)
    return cfg


def _facade(cfg):
    d = cfg["data"]
    return tfacades.PatchEkltPyramid2(
        (d["height"], d["width"]), (d["crop_height"], d["crop_width"]),
        solver_config=copy.deepcopy(cfg["solver"]), visualize_module=None,
        device=CPU)


def _frames(cfg, solv, n_frames=3):
    loader = tdata.collections["SYNTHETIC"](config=cfg["data"])
    loader.set_sequence(cfg["data"]["sequence"])
    flows, histories = [], []
    for i1 in range(1, 1 + n_frames):
        im1, t1 = loader.load_image(i1)
        _im2, t2 = loader.load_image(i1 + 1)
        ev = loader.load_event(max(loader.time_to_index(t1), 0),
                               min(loader.time_to_index(t2), len(loader)))
        filtered, _period = solv.preprocess(ev)
        handle = solv.estimate_async(filtered, frame=im1)
        histories.append(handle.loss_history)
        flows.append(handle.result())
    return flows, histories


def test_facade_programs_with_steady_n_iter(stub_graphs, monkeypatch):
    cfg = _facade_config(warm_start=True, steady_n_iter=12)
    kept = _facade(cfg)
    flows, histories = _frames(cfg, kept)
    assert sorted(s for _c, s in kept._programs) == [False, True]
    assert [len(h[0]) for h in histories] == [8, 4, 4]
    fresh = _facade(cfg)
    monkeypatch.setattr(fresh, "_program",
                        lambda capacity, steady=False: tpyr.SolveProgram(
                            fresh.spec_steady if steady else fresh.spec))
    flows_f, histories_f = _frames(cfg, fresh)
    assert all(np.array_equal(a, b) for a, b in zip(flows, flows_f))
    assert _same(histories, histories_f)


# ---------------------------------------------------------------------------
# (d) prewarm
# ---------------------------------------------------------------------------

def test_prewarm_captures_each_schedule_and_changes_no_frame(
        stub_graphs, caplog):
    cfg = _facade_config(warm_start=True, steady_n_iter=12)
    warmed, cold = _facade(cfg), _facade(cfg)
    before = warmed._generator.get_state()
    with caplog.at_level(logging.INFO, logger=tfacades.logger.name):
        warmed.prewarm(4096)
    lines = [r.getMessage() for r in caplog.records
             if "Capturing the solve program" in r.getMessage()]
    assert len(lines) == 2 and all("capacity 4096" in x for x in lines)
    assert torch.equal(warmed._generator.get_state(), before)
    captured = len(stub_graphs)
    assert captured == 5  # two scales, two schedules, and the IWE cache
    flows_w, hist_w = _frames(cfg, warmed)
    flows_c, hist_c = _frames(cfg, cold)
    assert all(np.array_equal(a, b) for a, b in zip(flows_w, flows_c))
    assert _same(hist_w, hist_c)
    assert torch.equal(warmed._generator.get_state(),
                       cold._generator.get_state())


# ---------------------------------------------------------------------------
# (e) launch accounting
# ---------------------------------------------------------------------------

def test_replays_count_the_captured_launches(monkeypatch):
    """A step that launches the forward stencil twice and the backward
    once: the eager warm-up steps count live, the capture counts nothing,
    each replay adds what the capture recorded."""
    runs = []

    def step():
        kernels.launched("cmax_stencil_fwd")
        kernels.launched("cmax_stencil_fwd")
        kernels.launched("cmax_stencil_bwd")
        runs.append(1)

    class Recording:
        def __init__(self, step, device):
            monkeypatch.setattr(kernels, "_capturing", lambda: True)
            try:
                step()  # what a capture records; nothing runs
            finally:
                monkeypatch.setattr(kernels, "_capturing", lambda: False)
            runs.pop()
            self.step = step
            self.pool_bytes = 0

        def replay(self):
            runs.append(1)  # the recorded kernels run; no Python does

    monkeypatch.setattr(graphs, "_capture", Recording)
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches,
                                                           0))
    g = graphs.StepGraph(step, torch.device(CPU))
    g.run(7)
    assert g.launches == {"cmax_stencil_fwd": 2, "cmax_stencil_bwd": 1}
    assert len(runs) == 7
    assert kernels.launches["cmax_stencil_fwd"] == 14
    assert kernels.launches["cmax_stencil_bwd"] == 7
    g.run(3)  # a later run replays only
    assert len(runs) == 10
    assert kernels.launches["cmax_stencil_fwd"] == 20
    assert kernels.launches["hat_vote_image"] == 0


def test_eager_loops_nests_and_the_cpu_never_captures():
    cuda = torch.device("cuda")
    assert not graphs.graph_route(torch.device(CPU))
    assert graphs.graph_route(cuda)
    with graphs.eager_loops():
        with graphs.eager_loops():
            assert not graphs.graph_route(cuda)
        assert not graphs.graph_route(cuda)
    assert graphs.graph_route(cuda)
    with torch.autograd.detect_anomaly(check_nan=True):
        assert not graphs.graph_route(cuda)


def test_a_loop_rejects_a_start_of_another_shape():
    loop = topt.FirstOrderLoop(lambda x: torch.sum(x * x), 4)
    loop.run(torch.ones(3))
    with pytest.raises(ValueError, match="iterate"):
        loop.run(torch.ones(4))
    res = loop.run(torch.full((3,), 2.0))
    want = topt.run_first_order(lambda x: torch.sum(x * x),
                                torch.full((3,), 2.0), 4)
    assert _same(dict(res), dict(want))


def test_set_learning_rate_rewrites_the_table():
    f = lambda x: torch.sum((x - 1.0) ** 2)  # noqa: E731
    loop = topt.FirstOrderLoop(f, 5, lr=0.1)
    loop.run(torch.zeros(2))
    loop.set_learning_rate(0.3)
    got = loop.run(torch.zeros(2))
    assert _same(dict(got), dict(topt.run_first_order(f, torch.zeros(2), 5,
                                                       lr=0.3)))
