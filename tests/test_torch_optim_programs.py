"""The optimizer families beside the first-order methods as device loops
(``optim.py``: ``LbfgsLoop``, ``NelderMeadLoop``, ``NewtonCgLoop``,
``SamplerProgram``) and the GML and CMax programs that keep them, on the
CPU.

The graph route runs here through the stand-in captures of
``torch_parity`` (``StubGraph`` for a step, ``StubWhile`` for L-BFGS's
while graph: each replays the recorded Python, the first replay under
``NoHostReads``, and the while stand-in reads the stop flag as the card's
WHILE node reads it).  With them:

* L-BFGS's pre-part, trial and post-part, a Nelder-Mead step, a Newton-CG
  step and a sampler's program run without a host read, and equal the
  eager route (``graphs.eager_loops()``) bit for bit; the while loop stops
  on the trial the eager loop stops on;
* the device line search matches optax iterate by iterate: float64 within
  1e-8 with optax's trials an iteration and best iterate, float32 within
  1e-5 relative;
* two frames through a kept ``GmlProgram`` and a kept ``CmaxProgram`` of
  each family equal two fresh solves bit for bit, capturing in the first
  frame only; the GML facade with ``BFGS`` keeps one program a capacity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import optax.tree_utils as otu
import pytest
import torch

import event_based_bos_tpu_torch.optim as topt
import event_based_bos_tpu_torch.solver.cmax as tcmax
import event_based_bos_tpu_torch.solver.facades as tfacades
import event_based_bos_tpu_torch.solver.generative as tgen
import event_based_bos_tpu_torch.solver.gml as tgml
from event_based_bos_tpu_torch import graphs
from event_based_bos_tpu_torch.types import events_from_ndarray
from test_torch_optim_methods import _gml_objectives, _quartic
from torch_parity import (CPU, StubGraph, StubWhile, clear_kept_programs,
                          same_bits, small_scene, stub_capture, torch_threads)

H, W = 64, 96
ROI = (0, H, 16, 80)
RESULT_KEYS = ("param", "loss", "best_iter", "history", "last_param")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture
def stub(monkeypatch):
    """The graph route on the CPU through the stand-in captures."""
    yield stub_capture(monkeypatch)
    clear_kept_programs()


def _same_result(a, b, keys=RESULT_KEYS):
    return all(same_bits(a[k], b[k]) for k in keys)


def _quartic32(seed=1, d=4):
    """``_quartic`` in float32 in both packages."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(d, d))
    a = (m @ m.T + np.eye(d)).astype(np.float32)
    b = rng.normal(size=d).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)

    def jf(x):
        return 0.5 * x @ (a @ x) - b @ x + 0.05 * jnp.sum(x ** 4)

    def tf(x):
        return 0.5 * x @ (ta @ x) - tb @ x + 0.05 * torch.sum(x ** 4)

    return jf, tf, rng.normal(size=d).astype(np.float32)


def _problem(name):
    if name == "gml":
        return _gml_objectives()
    if name == "quartic32":
        return _quartic32()
    return _quartic()


# ---------------------------------------------------------------------------
# the loops' captured parts: no host read, the eager route's bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("problem,n_iter,bounded", [
    ("quartic", 10, False), ("quartic32", 8, False), ("gml", 6, False),
    ("quartic", 8, True)])
def test_lbfgs_while_graph_is_free_of_host_reads_and_exact(
        stub, problem, n_iter, bounded):
    _jf, tf, x0 = _problem(problem)
    x0 = torch.as_tensor(x0)
    bounds = ((torch.full_like(x0, -0.3), torch.full_like(x0, 0.3))
              if bounded else None)
    loop = topt.LbfgsLoop(tf, n_iter, bounds=bounds)
    first = loop.run(x0)
    second = loop.run(x0)  # the loop and its graph reused
    with graphs.eager_loops():
        want = topt.run_lbfgs(tf, x0, n_iter, bounds=bounds)
    (captured,) = StubWhile.captured
    trials = int(want.ls_trials.sum())
    assert captured.replays == 2 * n_iter and not stub
    # the stand-in's loop stops on the eager loop's trials
    assert captured.trials == 2 * trials
    assert want.host_reads == trials and first.host_reads == 0
    for got in (first, second):
        assert _same_result(got, want, RESULT_KEYS + ("ls_trials",))
    assert int(want.ls_trials.min()) >= 1


@pytest.mark.parametrize("family", ["nelder_mead", "newton_cg"])
@pytest.mark.parametrize("problem,bounded", [("quartic", False),
                                             ("gml", False),
                                             ("quartic", True)])
def test_step_loops_are_free_of_host_reads_and_exact(stub, family, problem,
                                                     bounded):
    _jf, tf, x0 = _problem(problem)
    x0 = torch.as_tensor(x0)
    bounds = ((torch.full_like(x0, -0.3), torch.full_like(x0, 0.3))
              if bounded else None)
    make = topt.NelderMeadLoop if family == "nelder_mead" \
        else topt.NewtonCgLoop
    n_iter = 15 if family == "nelder_mead" else 4
    loop = make(tf, n_iter, bounds=bounds)
    first = loop.run(x0)
    second = loop.run(x0)
    with graphs.eager_loops():
        want = make(tf, n_iter, bounds=bounds).run(x0)
    (graph,) = stub
    assert graph.replays == 2 * n_iter - graphs.WARMUP_STEPS
    assert _same_result(first, want) and _same_result(second, want)


@pytest.mark.parametrize("sampler,n_trials", [("random", 40), ("grid", 25),
                                              ("uniform", 10), ("TPE", 40)])
def test_sampler_program_is_free_of_host_reads_and_exact(stub, sampler,
                                                         n_trials):
    c = torch.tensor([0.7, -1.1, 0.2, 0.4], dtype=torch.float64)

    def tf(x):  # float32 samples, a float64 objective
        return torch.sum((x - c) ** 2) + 0.1 * torch.sum(x ** 4)

    box = ([-3.0, -2.0, -2.0, -1.0], [3.0, 2.0, 1.0, 1.0])
    program = topt.SamplerProgram(tf, box, n_trials, sampler, CPU)
    for seed in (0, 1, 2):  # eager + capture, then two replays
        g = torch.Generator().manual_seed(seed)
        got = program.run(g)
        ref = torch.Generator().manual_seed(seed)
        with graphs.eager_loops():
            want = topt.run_sampler(tf, box, n_trials, sampler, ref)
        assert _same_result(got, want)
        # the draws came from the generator as the per-call route takes them
        assert torch.equal(g.get_state(), ref.get_state())
    (graph,) = stub
    assert graph.replays == 2


def test_sampler_program_defaults_to_the_card(monkeypatch):
    """``device=None`` means the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topt.SamplerProgram(lambda x: torch.sum(x), ([0.0], [1.0]), 4)


# ---------------------------------------------------------------------------
# the device line search against optax
# ---------------------------------------------------------------------------

def _optax_lbfgs(jf, x0, n_iter):
    """optax's L-BFGS step by step (jitted) with the JAX package's
    best-iterate rule (``jopt.run_lbfgs``): the loss before each step, the
    line search's trials of each step, the returned iterate and its
    step."""
    opt = optax.lbfgs(memory_size=10)

    @jax.jit
    def step(x, state):
        loss, grad = jax.value_and_grad(jf)(x)
        updates, state = opt.update(grad, state, x, value=loss, grad=grad,
                                    value_fn=jf)
        x_new = optax.apply_updates(x, updates)
        return (x_new, state, loss, jf(x_new),
                otu.tree_get(state, "num_linesearch_steps"))

    x = jnp.asarray(x0)
    state = opt.init(x)
    xs, losses, trials = [], [], []
    for _ in range(n_iter):
        xs.append(np.asarray(x))
        x, state, loss, final, n = step(x, state)
        losses.append(float(loss))
        trials.append(int(n))
    best = int(np.argmin(losses))
    if float(final) < losses[best]:
        best, param = n_iter - 1, np.asarray(x)
    else:
        param = xs[best]
    return np.asarray(losses), trials, param, best


@pytest.mark.parametrize("problem,n_iter", [("quartic", 3), ("quartic", 10),
                                            ("gml", 10)])
def test_device_line_search_matches_optax_trial_for_trial(stub, problem,
                                                          n_iter):
    jf, tf, x0 = _problem(problem)
    losses, trials, param, best = _optax_lbfgs(jf, x0, n_iter)
    got = topt.run_lbfgs(tf, torch.as_tensor(x0), n_iter)
    np.testing.assert_allclose(got.history.numpy(), losses, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.param.numpy(), param, rtol=0, atol=1e-8)
    assert got.ls_trials.tolist() == trials
    assert int(got.best_iter) == best


def test_device_line_search_float32_within_1e5():
    """float32 (the line search's scalars in the iterate's dtype, as optax
    keeps them), 5 iterations: within 1e-5 relative of optax."""
    jf, tf, x0 = _quartic32()
    losses, _trials, param, _best = _optax_lbfgs(jf, x0, 5)
    got = topt.run_lbfgs(tf, torch.as_tensor(x0), 5)
    assert got.param.dtype == torch.float32
    np.testing.assert_allclose(got.history.numpy(), losses, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.param.numpy(), param, rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the GML and CMax programs that keep the loops
# ---------------------------------------------------------------------------

def _captures():
    return len(StubGraph.captured) + len(StubWhile.captured)


def _frames():
    out = []
    for seed in (0, 1):
        events, frame, _gt = small_scene(seed=seed)
        out.append((events_from_ndarray(events.astype(np.float32),
                                        device=CPU, dtype=torch.float64),
                    torch.as_tensor(frame, dtype=torch.float64)))
    return out


GML_METHODS = {"BFGS": 6, "Nelder-Mead": 20, "Newton-CG": 3, "random": 32,
               "grid": 25}


def _gml_spec(method):
    sampler = method in ("random", "grid")
    gen = tgen.GenerativeSpec(
        image_size=(H, W), iwe_sigma=2.0, weight_by_inverse_event_hist=True,
        optimize_warp=not sampler, poisson_model=False, dtype=torch.float64,
        cost_weights=((("diff_norm", 1.0),) if sampler else
                      (("diff_norm", 1.0), ("flow_norm_pxy", 0.1))))
    return tgml.GmlSpec(gen=gen, roi=ROI, method=method,
                        n_iter=GML_METHODS[method],
                        param_bounds=((-3.0, 3.0),) * 2 if sampler else ())


@pytest.mark.parametrize("method", list(GML_METHODS))
def test_kept_gml_program_equals_fresh_solves(stub, method):
    spec = _gml_spec(method)
    x0 = None if method in ("random", "grid") else np.array(
        [0.1, -0.1, 0.0, 0.0])
    program = tgml.GmlProgram(spec)

    def solve(ev, frame, program=None):
        return tgml.estimate_frame_gml(
            ev, frame, torch.Generator().manual_seed(3), spec, x0=x0,
            device=CPU, program=program)

    kept, counts = [], []
    for ev, frame in _frames():
        kept.append(solve(ev, frame, program))
        counts.append(_captures())
    fresh = [solve(ev, frame) for ev, frame in _frames()]
    assert counts[0] > 0 and counts[1] == counts[0], counts
    for (flow, aux), (flow_f, aux_f) in zip(kept, fresh):
        assert same_bits(flow, flow_f)
        assert same_bits({k: aux[k] for k in ("theta", "loss", "history")},
                         {k: aux_f[k] for k in ("theta", "loss", "history")})
        if method == "BFGS":
            assert aux["host_reads"] == 0 and aux_f["host_reads"] == 0
            assert same_bits(aux["ls_trials"], aux_f["ls_trials"])
    assert not same_bits(kept[0][1]["theta"], kept[1][1]["theta"])


def _dots(vx, vy, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, n))
    x = rng.choice(np.arange(6, H - 14, 4), n) + vx * t + rng.normal(0, .1, n)
    y = rng.choice(np.arange(6, W - 14, 5), n) + vy * t + rng.normal(0, .1, n)
    return events_from_ndarray(np.stack([x, y, t, np.ones(n)], 1),
                               device=CPU, dtype=torch.float64)


@pytest.mark.parametrize("method,n_iter", [("BFGS", 6), ("Nelder-Mead", 20),
                                           ("random", 32), ("TPE", 32)])
def test_kept_cmax_translation_program_equals_fresh_solves(stub, method,
                                                           n_iter):
    spec = tcmax.CmaxSpec(image_size=(H, W), roi=ROI,
                          motion_model="2d-translation", n_iter=n_iter,
                          method=method, time_bins=4, dtype=torch.float64,
                          param_bounds=((-4.0, 4.0),) * 2)
    program = tcmax.CmaxProgram(spec)
    frames = [_dots(2.0, -3.0, seed=0), _dots(-1.5, 2.5, seed=1)]

    def solve(ev, program=None):
        return tcmax.estimate_frame_cmax(
            ev, None, torch.Generator().manual_seed(5), spec, device=CPU,
            program=program)

    kept, counts = [], []
    for ev in frames:
        kept.append(solve(ev, program))
        counts.append(_captures())
    fresh = [solve(ev) for ev in frames]
    assert counts[0] > 0 and counts[1] == counts[0], counts
    for (flow, aux), (flow_f, aux_f) in zip(kept, fresh):
        assert same_bits(flow, flow_f)
        assert same_bits(aux["history"], aux_f["history"])
    assert not same_bits(kept[0][0], kept[1][0])


def test_gml_facade_keeps_one_bfgs_program_per_capacity(stub):
    box = {"min": -3.0, "max": 3.0}
    solver_config = {
        "method": "generative_max_likelihood",
        "optimizer": {"method": "BFGS", "n_iter": 4,
                      "parameters": {"v_x": box, "v_y": box}},
        "generative_ml": {"iwe_sigma": 2, "optimize_warp": True},
        "precision": "64"}
    solv = tfacades.collections["generative_max_likelihood"](
        (H, W), (H, W), solver_config=solver_config, device=CPU)
    (ev0, frame0), (ev1, frame1) = _frames()
    small = ev0.capacity
    handles = [solv.estimate_async(ev, frame=frame)
               for ev, frame in ((ev0, frame0), (ev1, frame1))]
    flows = [h.result() for h in handles]
    assert list(solv._programs) == [small]
    assert [h.host_reads for h in handles] == [0, 0]
    assert len(StubWhile.captured) == 1
    big = events_from_ndarray(small_scene(seed=0)[0].astype(np.float32),
                              capacity=2 * small, device=CPU,
                              dtype=torch.float64)
    solv.estimate_async(big, frame=frame0).result()
    assert sorted(solv._programs) == [small, 2 * small]
    assert len(StubWhile.captured) == 2
    assert not np.array_equal(flows[0], flows[1])
