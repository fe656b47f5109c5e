"""Step-by-step parity of the port's Adam loop with the JAX package's
``run_first_order`` (optax Adam + staircase decay + best tracking).

The objective is a small quadratic plus an absolute-value term, so some
gradients sit near zero, where Adam's steps are sign-like.  Every loss of
the history, the per-term history, the best loss, its step and the
returned iterate must agree to ≤ 1e-6 (relative for float32, absolute
1e-12 for float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.optim as jopt
import event_based_bos_tpu_torch.optim as topt
from torch_parity import np_of

TDT = {"float32": torch.float32, "float64": torch.float64}


def _problem(dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 2.0, (3, 4)).astype(dtype)
    c = rng.normal(size=(3, 4)).astype(dtype)
    x0 = rng.normal(size=(3, 4)).astype(dtype)
    return a, c, x0


def _objectives(a, c):
    def jf(x):
        quad = jnp.sum(a * (x - c) ** 2)
        l1 = jnp.sum(jnp.abs(x))
        return quad + 0.3 * l1, {"quad": quad, "l1": l1}

    ta, tc = torch.as_tensor(a), torch.as_tensor(c)

    def tf(x):
        quad = torch.sum(ta * (x - tc) ** 2)
        l1 = torch.sum(torch.abs(x))
        return quad + 0.3 * l1, {"quad": quad, "l1": l1}

    return jf, tf


def _check(got, want, dtype):
    got, want = np_of(got), np_of(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("track_best", [True, False])
@pytest.mark.parametrize("lr_step", [None, 7])
def test_run_first_order_matches_optax(dtype, track_best, lr_step):
    a, c, x0 = _problem(dtype)
    jf, tf = _objectives(a, c)
    kw = dict(n_iter=24, lr=0.2, lr_decay=0.5, lr_step=lr_step,
              track_best=track_best, has_aux=True, record_every=5)
    want = jopt.run_first_order(jf, jnp.asarray(x0), **kw)
    got = topt.run_first_order(tf, torch.as_tensor(x0), **kw)
    assert got.history.shape == (24,) and got.history.dtype == TDT[dtype]
    _check(got.history, want.history, dtype)
    for k in ("quad", "l1"):
        _check(got.aux_history[k], want.aux_history[k], dtype)
    _check(got.param, want.param, dtype)
    _check(got.last_param, want.last_param, dtype)
    _check(got.loss, want.loss, dtype)
    assert int(got.best_iter) == int(want.best_iter)
    assert got.params_history.shape == (5, 3, 4)
    _check(got.params_history, want.params_history, dtype)


def test_track_best_is_strict_and_by_value():
    """A loss that rises after step 0 keeps the step-0 iterate; equal later
    losses do not replace it (strict ``<``)."""
    x0 = torch.tensor([1.0], dtype=torch.float64)

    def flat(x):
        return (x * 0.0).sum() + 1.0

    res = topt.run_first_order(flat, x0, 5, lr=0.1)
    assert int(res.best_iter) == 0 and float(res.loss) == 1.0
    assert torch.equal(res.param, x0)

    def rising(x):
        return (x * x).sum()

    res = topt.run_first_order(rising, torch.tensor([0.0]), 4, lr=0.1)
    assert int(res.best_iter) == 0 and torch.equal(res.param,
                                                   torch.tensor([0.0]))


def test_bounds_project_iterates():
    a, c, x0 = _problem("float64", seed=1)
    jf, tf = _objectives(a, c)
    lo, hi = -0.25 * np.ones_like(x0), 0.25 * np.ones_like(x0)
    want = jopt.run_first_order(lambda x: jf(x)[0], jnp.asarray(x0), 10,
                                lr=0.1, bounds=(jnp.asarray(lo),
                                                jnp.asarray(hi)))
    got = topt.run_first_order(lambda x: tf(x)[0], torch.as_tensor(x0), 10,
                               lr=0.1, bounds=(torch.as_tensor(lo),
                                               torch.as_tensor(hi)))
    _check(got.history, want.history, "float64")
    _check(got.param, want.param, "float64")
    assert got.aux_history is None


def test_make_optimizer_methods():
    assert isinstance(topt.make_optimizer("Adam", 0.1, 10, 0.1), topt.Adam)
    assert isinstance(topt.make_optimizer("SGD", 0.1, 10, 0.1), topt.SGD)
    assert isinstance(topt.make_optimizer("ASGD", 0.1, 10, 0.1), topt.SGD)
    with pytest.raises(TypeError, match="Rprop"):
        topt.make_optimizer("Rprop", 0.1, 10, 0.1)
    with pytest.raises(KeyError):
        topt.make_optimizer("Nope", 0.1, 10, 0.1)
    opt = topt.make_optimizer("Adam", 0.1, 10, 0.5)
    # optax evaluates its schedule in float32
    assert [opt.learning_rate(c) for c in (0, 9, 10, 25)] == [
        float(np.float32(v)) for v in (0.1, 0.1, 0.05, 0.025)]
