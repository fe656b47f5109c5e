"""The port's optimizer families (``optim.py``) against the JAX package's.

The same numpy inputs go through each package's loop:

* every first-order name step by step against optax (``record_every=1``:
  each iterate and each loss), float64 within 1e-12, float32 within 1e-6
  relative; ``Rprop`` raises in both;
* L-BFGS (optax's, with its zoom line search) iterate by iterate on a
  quartic-plus-quadratic bowl and on a small float64 GML objective, within
  1e-8;
* Nelder-Mead and Newton-CG within 1e-10 in float64, unbounded, bounded and
  with x0 on the bounds (the cases of ``tests/test_costs_optim.py``);
* the grid sampler exactly on a grid whose spacing float32 holds exactly
  (elsewhere XLA's CPU ``linspace`` multiplies by a rounded reciprocal and
  fuses, so its points may differ by an ulp), ``random`` and the two-stage
  ``TPE`` stand-in on the JAX package's draws, passed in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.optim as jopt
import event_based_bos_tpu.solver.generative as jgen
import event_based_bos_tpu_torch.optim as topt
import event_based_bos_tpu_torch.solver.generative as tgen
from torch_parity import np_of, small_scene, torch_threads

FIRST_ORDER = ["Adam", "AdamW", "Adamax", "NAdam", "RAdam", "Adagrad",
               "Adadelta", "RMSprop", "SGD", "ASGD"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _bowl(dtype, seed=0):
    """A bowl with a kink and a quartic: ``(jax_f, torch_f, x0)``."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 2.0, (3, 4)).astype(dtype)
    c = rng.normal(size=(3, 4)).astype(dtype)
    x0 = rng.normal(size=(3, 4)).astype(dtype)
    ta, tc = torch.as_tensor(a), torch.as_tensor(c)

    def jf(x):
        return (jnp.sum(a * (x - c) ** 2) + 0.3 * jnp.sum(jnp.abs(x))
                + 0.1 * jnp.sum(x ** 4))

    def tf(x):
        return (torch.sum(ta * (x - tc) ** 2) + 0.3 * torch.sum(torch.abs(x))
                + 0.1 * torch.sum(x ** 4))

    return jf, tf, x0


def _quartic(seed=1, d=4):
    """A smooth convex function of a ``[d]`` vector."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(d, d))
    a = m @ m.T + np.eye(d)
    b = rng.normal(size=d)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)

    def jf(x):
        return 0.5 * x @ (a @ x) - b @ x + 0.05 * jnp.sum(x ** 4)

    def tf(x):
        return 0.5 * x @ (ta @ x) - tb @ x + 0.05 * torch.sum(x ** 4)

    return jf, tf, rng.normal(size=d)


def _close(got, want, atol):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=0, atol=atol)


@pytest.mark.parametrize("method", FIRST_ORDER)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_first_order_methods_step_by_step(method, dtype):
    jf, tf, x0 = _bowl(dtype)
    kw = dict(n_iter=25, method=method, lr=0.05, lr_decay=0.5, lr_step=7,
              record_every=1)
    want = jopt.run_first_order(jf, jnp.asarray(x0), **kw)
    got = topt.run_first_order(tf, torch.as_tensor(x0), **kw)
    assert got.params_history.shape == (25, 3, 4)
    if dtype == "float64":
        for k in ("params_history", "history", "param", "last_param",
                  "loss"):
            _close(got[k], want[k], 1e-12)
    else:
        for k in ("params_history", "history", "last_param"):
            np.testing.assert_allclose(np_of(got[k]), np_of(want[k]),
                                       rtol=1e-6, atol=1e-6)
    assert int(got.best_iter) == int(want.best_iter)


def test_rprop_raises_in_both_packages():
    jf, tf, x0 = _bowl("float64")
    with pytest.raises(TypeError):
        jopt.run_first_order(jf, jnp.asarray(x0), 3, "Rprop")
    with pytest.raises(TypeError, match="Rprop"):
        topt.run_first_order(tf, torch.as_tensor(x0), 3, "Rprop")
    with pytest.raises(KeyError):
        topt.make_optimizer("Nope", 0.1, 10, 0.1)


def test_vector_loss_rows_are_independent_problems():
    """A ``[n]`` loss: each row follows its own solve, the best iterate is
    tracked per row, the history is ``[n_iter, n]``."""
    _jf, tf, x0 = _bowl("float64")

    def rows(x):
        return torch.stack([tf(x[i]) for i in range(x.shape[0])])

    batch = torch.as_tensor(np.stack([x0, -x0, 0.5 * x0]))
    got = topt.run_first_order(rows, batch, 20, "Adam", lr=0.2)
    assert got.history.shape == (20, 3) and got.loss.shape == (3,)
    for i in range(3):
        one = topt.run_first_order(tf, batch[i], 20, "Adam", lr=0.2)
        _close(got.param[i], one.param, 1e-12)
        _close(got.history[:, i], one.history, 1e-12)
        assert int(got.best_iter[i]) == int(one.best_iter)


def _gml_objectives():
    """The float64 GML objective (plain model with the warp pair) of the
    small synthetic scene, its constants made once with the port and handed
    to both packages as numpy arrays."""
    from event_based_bos_tpu_torch.ops.gradients import frame_gradients
    from event_based_bos_tpu_torch.types import events_from_ndarray

    events, frame, _gt = small_scene()
    h, w = frame.shape
    roi = (0, h, 16, 80)
    kw = dict(image_size=(h, w), optimize_warp=True, poisson_model=False,
              iwe_sigma=2.0, weight_by_inverse_event_hist=True)
    js = jgen.GenerativeSpec(dtype=jnp.float64, **kw)
    ts = tgen.GenerativeSpec(dtype=torch.float64, **kw)
    ev = events_from_ndarray(events, dtype=torch.float64, device="cpu")
    hist, _w, wi = tgen.iwe_cache(ev, ts)
    gx, gy = frame_gradients(torch.as_tensor(frame, dtype=torch.float64))
    mroi = tgen.measured_increment(hist, None, roi=roi)
    consts = [np_of(a) for a in (mroi, gx, gy, wi)]

    def jf(t):
        return jgen.scalar_objective(t, *consts, roi, js)[0]

    targs = [torch.as_tensor(a) for a in consts]

    def tf(t):
        return tgen.scalar_objective(t, *targs, roi, ts)[0]

    return jf, tf, np.array([0.1, -0.1, 0.0, 0.0])


@pytest.mark.parametrize("problem,n_iter", [("quartic", 3), ("quartic", 10),
                                            ("gml", 10)])
def test_lbfgs_matches_optax_iterate_by_iterate(problem, n_iter):
    jf, tf, x0 = _quartic() if problem == "quartic" else _gml_objectives()
    want = jopt.run_lbfgs(jf, jnp.asarray(x0), n_iter)
    got = topt.run_lbfgs(tf, torch.as_tensor(x0), n_iter)
    for k in ("history", "param", "last_param", "loss"):
        _close(got[k], want[k], 1e-8)
    assert int(got.best_iter) == int(want.best_iter)
    # on the CPU the line search reads its stop flag once a trial, and
    # nothing else is read: 1 to 20 trials an iteration
    trials = int(got.ls_trials.sum())
    assert got.host_reads == trials
    assert n_iter <= trials <= 20 * n_iter


def test_lbfgs_bounds_project_every_iterate():
    jf, tf, _x0 = _quartic()
    lo, hi = -0.3 * np.ones(4), 0.3 * np.ones(4)
    x0 = np.full(4, 0.3)
    want = jopt.run_lbfgs(jf, jnp.asarray(x0), 8,
                          bounds=(jnp.asarray(lo), jnp.asarray(hi)))
    got = topt.run_lbfgs(tf, torch.as_tensor(x0), 8,
                         bounds=(torch.as_tensor(lo), torch.as_tensor(hi)))
    _close(got.history, want.history, 1e-8)
    _close(got.param, want.param, 1e-8)
    assert (np.abs(np_of(got.last_param)) <= 0.3).all()


def _kink_jax(x):
    return jnp.abs(x[0] - 1.0) + jnp.abs(x[1] + 2.0) + (x[2] - 0.5) ** 2


def _kink_torch(x):
    # |·| of a difference away from 0: no gradient is taken here
    return torch.abs(x[0] - 1.0) + torch.abs(x[1] + 2.0) + (x[2] - 0.5) ** 2


def _bowl2_jax(x):
    return (x[0] - 0.2) ** 2 + (x[1] + 0.3) ** 2


def _bowl2_torch(x):
    return (x[0] - 0.2) ** 2 + (x[1] + 0.3) ** 2


@pytest.mark.parametrize("case", ["quartic", "kink", "kink_bounded",
                                  "x0_on_bound", "gml"])
def test_nelder_mead_matches_jax(case):
    bounds = None
    if case == "quartic":
        jf, tf, x0 = _quartic()
    elif case == "gml":
        jf, tf, x0 = _gml_objectives()
    elif case.startswith("kink"):
        jf, tf, x0 = _kink_jax, _kink_torch, np.zeros(3)
        if case == "kink_bounded":
            bounds = (-0.5 * np.ones(3), 0.5 * np.ones(3))
    else:
        jf, tf, x0 = _bowl2_jax, _bowl2_torch, np.ones(2)
        bounds = (-np.ones(2), np.ones(2))
    n = 60
    want = jopt.run_nelder_mead(
        jf, jnp.asarray(x0), n,
        bounds=None if bounds is None else tuple(map(jnp.asarray, bounds)))
    got = topt.run_nelder_mead(
        tf, torch.as_tensor(x0), n,
        bounds=None if bounds is None else tuple(map(torch.as_tensor,
                                                     bounds)))
    _close(got.history, want.history, 1e-10)
    _close(got.param, want.param, 1e-10)
    if case == "x0_on_bound":
        # the simplex leaves the bound (the perturbation points inward)
        assert np.abs(np_of(got.param) - [1.0, 1.0]).min() > 0.1


def test_nelder_mead_orders_ties_stably():
    """A flat objective: every vertex ties, and the stable order keeps the
    simplex as JAX's ``argsort`` keeps it."""
    x0 = np.array([0.5, -0.25])
    want = jopt.run_nelder_mead(lambda x: jnp.sum(x * 0.0) + 1.0,
                                jnp.asarray(x0), 12)
    got = topt.run_nelder_mead(lambda x: torch.sum(x * 0.0) + 1.0,
                               torch.as_tensor(x0), 12)
    _close(got.param, want.param, 0.0)


@pytest.mark.parametrize("case", ["quartic", "gml", "bounded",
                                  "x0_on_bound"])
def test_newton_cg_matches_jax(case):
    bounds = None
    if case == "gml":
        jf, tf, x0 = _gml_objectives()
    else:
        jf, tf, x0 = _quartic()
        if case != "quartic":
            bounds = (-0.3 * np.ones(4), 0.3 * np.ones(4))
            if case == "x0_on_bound":
                x0 = np.full(4, 0.3)
    want = jopt.run_newton_cg(
        jf, jnp.asarray(x0), 6,
        bounds=None if bounds is None else tuple(map(jnp.asarray, bounds)))
    got = topt.run_newton_cg(
        tf, torch.as_tensor(x0), 6,
        bounds=None if bounds is None else tuple(map(torch.as_tensor,
                                                     bounds)))
    for k in ("history", "param", "last_param", "loss"):
        _close(got[k], want[k], 1e-10)
    assert int(got.best_iter) == int(want.best_iter)


def test_newton_cg_refuses_a_kernel_without_second_derivative():
    """The CMax stencil's autograd Function has no second derivative: its
    backward raises under ``create_graph`` rather than give a partial
    Hessian-vector product (here with a second, smooth term beside it)."""
    from event_based_bos_tpu_torch.ops.cmax_cuda import \
        binned_warp_accumulate

    hists = torch.rand(4, 12, 16, generator=torch.Generator().manual_seed(0))
    dts = torch.linspace(-0.4, 0.4, 4)

    def objective(x):
        flow = x[:, None, None].expand(2, 12, 16)
        return (-torch.var(binned_warp_accumulate(hists, flow, dts, 2))
                + torch.sum(x * x))

    with pytest.raises(RuntimeError, match="second derivative"):
        topt.run_newton_cg(objective, torch.tensor([0.3, -0.2]), 2)
    # first-order use is unaffected
    assert np.isfinite(float(topt.run_lbfgs(objective,
                                            torch.tensor([0.3, -0.2]),
                                            2).loss))


@pytest.mark.parametrize("method,family", [
    ("BFGS", "run_lbfgs"), ("L-BFGS-B", "run_lbfgs"), ("CG", "run_lbfgs"),
    ("Nelder-Mead", "run_nelder_mead"), ("Powell", "run_nelder_mead"),
    ("Newton-CG", "run_newton_cg"), ("trust-constr", "run_newton_cg")])
def test_scipy_method_routing(monkeypatch, method, family):
    """Each method runs its family's loop once (the loop that
    ``family`` runs) and releases it."""
    seen = []

    class Loop:
        def __init__(self, *a, **k):
            seen.append(family)

        def run(self, x0):
            return "ran"

        def release(self):
            seen.append("released")

    loop = {"run_lbfgs": "LbfgsLoop", "run_nelder_mead": "NelderMeadLoop",
            "run_newton_cg": "NewtonCgLoop"}[family]
    monkeypatch.setattr(topt, loop, Loop)
    assert topt.run_scipy_method(None, None, 3, method) == "ran"
    assert seen == [family, "released"]


def _sampler_problem():
    c = np.array([0.7, -1.1])

    def jf(x):
        return jnp.sum((x - c) ** 2)

    def tf(x):
        return torch.sum((x - torch.as_tensor(c)) ** 2)

    return jf, tf


def test_grid_sampler_exactly():
    jf, tf = _sampler_problem()
    bounds = ([-3.0, -2.0], [3.0, 2.0])
    # round(81^(1/2)) = 9 points an axis: a spacing of (hi − lo) / 8
    want = jopt.run_sampler(jf, tuple(map(jnp.asarray, bounds)), 81, "grid")
    got = topt.run_sampler(tf, bounds, 81, "grid")
    assert got.history.shape == (81,) and got.param.dtype == torch.float32
    assert np.array_equal(np_of(got.param), np_of(want.param))
    assert np.array_equal(np_of(got.history), np_of(want.history))
    assert int(got.best_iter) == int(want.best_iter)
    # "uniform" is the same grid; 10 trials in 2-D round to 3 an axis
    other = topt.run_sampler(tf, bounds, 10, "uniform")
    assert other.history.shape == (9,)


def test_grid_sampler_points_within_an_ulp():
    """round(512^(1/2)) = 23 points an axis, a spacing float32 rounds."""
    jf, tf = _sampler_problem()
    bounds = ([-3.0, -3.0], [3.0, 3.0])
    want = jopt.run_sampler(jf, tuple(map(jnp.asarray, bounds)), 512, "grid")
    got = topt.run_sampler(tf, bounds, 512, "grid")
    assert got.history.shape == (529,)
    np.testing.assert_allclose(np_of(got.param), np_of(want.param), rtol=0,
                               atol=5e-7)
    # the bowl's slope (≤ 9) times the points' difference, in float32
    np.testing.assert_allclose(np_of(got.history), np_of(want.history),
                               rtol=1e-6, atol=1e-5)


def _jax_draws(key, sampler, n, dim, lo, hi):
    """The JAX package's draws of ``run_sampler``, for the port's
    ``draws=``."""
    k1, k2 = jax.random.split(key)
    n1 = n if sampler == "random" else max(n // 2, 1)
    draws = {"uniform": np.asarray(jax.random.uniform(
        k1, (n1, dim), jnp.float32, jnp.asarray(lo, jnp.float32),
        jnp.asarray(hi, jnp.float32)))}
    if sampler == "TPE":
        n2, n_top = n - n1, max(n1 // 10, 1)
        draws["pick"] = np.asarray(jax.random.randint(k2, (n2,), 0, n_top))
        draws["noise"] = np.asarray(jax.random.normal(
            jax.random.fold_in(k2, 1), (n2, dim), jnp.float32))
    return draws


@pytest.mark.parametrize("sampler", ["random", "TPE"])
def test_random_and_two_stage_samplers_on_jax_draws(sampler, caplog):
    jf, tf = _sampler_problem()
    lo, hi = [-3.0, -2.0], [3.0, 2.0]
    key = jax.random.PRNGKey(4)
    want = jopt.run_sampler(jf, (jnp.asarray(lo), jnp.asarray(hi)), 64,
                            sampler, key)
    got = topt.run_sampler(tf, (lo, hi), 64, sampler,
                           draws=_jax_draws(key, sampler, 64, 2, lo, hi))
    assert np.array_equal(np_of(got.param), np_of(want.param))
    np.testing.assert_allclose(np_of(got.history), np_of(want.history),
                               rtol=1e-12, atol=0)
    assert int(got.best_iter) == int(want.best_iter)
    assert ("two-stage" in caplog.text) == (sampler == "TPE")


def test_samplers_draw_from_the_generator():
    _jf, tf = _sampler_problem()
    bounds = ([-3.0, -2.0], [3.0, 2.0])
    g = torch.Generator().manual_seed(3)
    a = topt.run_sampler(tf, bounds, 40, "TPE", g)
    b = topt.run_sampler(tf, bounds, 40, "TPE",
                         torch.Generator().manual_seed(3))
    assert torch.equal(a.history, b.history)
    assert a.history.shape == (40,)
    xs = np_of(a.param)
    assert (xs >= [-3.0, -2.0]).all() and (xs <= [3.0, 2.0]).all()
    with pytest.raises(KeyError):
        topt.run_sampler(tf, bounds, 4, "sobol")
