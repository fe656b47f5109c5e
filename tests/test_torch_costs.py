"""Parity of the port's cost terms, values and gradients, with JAX
(the generative terms and the CMax contrast terms).

Gradients are compared with ``jax.grad``.  Float64 inputs (the conftest
enables x64) so the comparison is of the formulas: ≤ 1e-10 relative.  The
all-zero translation field must give a finite loss and a zero (not NaN)
subgradient, as the double-``where`` norm guarantees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.costs as jcosts
import event_based_bos_tpu_torch.costs as tcosts
from torch_parity import np_of, rel_err

H, W = 12, 18
KEYS = ("prediction", "measurement", "flow", "pxy", "weights")


def _arg(seed=0, zero_pxy=False):
    rng = np.random.default_rng(seed)
    arg = {
        "prediction": rng.normal(size=(H, W)),
        "measurement": rng.normal(size=(H, W)),
        "flow": rng.normal(size=(2, H, W)),
        "pxy": np.zeros((2, H, W)) if zero_pxy else rng.normal(size=(2, H, W)),
        "weights": rng.uniform(0.05, 1.0, (H, W)),
    }
    return arg


def _value_and_grads(name_or_fn, arg, jax_side):
    """Value and gradients with respect to every array key."""
    if jax_side:
        fn = (jcosts.functions[name_or_fn] if isinstance(name_or_fn, str)
              else name_or_fn)

        def f(*xs):
            out = fn(dict(zip(KEYS, xs), omit_boundary=True))
            return out[0] if isinstance(out, tuple) else out

        xs = [jnp.asarray(arg[k]) for k in KEYS]
        val, grads = jax.value_and_grad(f, argnums=tuple(range(len(KEYS))))(
            *xs)
        return np_of(val), [np_of(g) for g in grads]
    fn = (tcosts.functions[name_or_fn] if isinstance(name_or_fn, str)
          else name_or_fn)
    xs = [torch.as_tensor(arg[k]).requires_grad_(True) for k in KEYS]
    out = fn(dict(zip(KEYS, xs), omit_boundary=True))
    out = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(out, xs, allow_unused=True)
    return np_of(out), [np.zeros(x.shape) if g is None else np_of(g)
                        for x, g in zip(xs, grads)]


@pytest.mark.parametrize("name", ["diff_norm", "flow_norm", "flow_norm_pxy",
                                  "image_gradient", "total_variation",
                                  "charbonnier"])
def test_cost_value_and_gradient(name):
    arg = _arg(1)
    jv, jg = _value_and_grads(name, arg, True)
    tv, tg = _value_and_grads(name, arg, False)
    assert rel_err(tv, jv) <= 1e-10
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_diff_norm_is_induced_one_norm_and_splits_ties():
    d = np.zeros((4, 3))
    d[:, 0] = 1.0
    d[:, 2] = [0.5, 0.5, 2.0, 1.0]  # column sums 4, 0, 4: a tie
    arg = {"prediction": torch.as_tensor(d, dtype=torch.float64)
           .requires_grad_(True),
           "measurement": torch.zeros((4, 3), dtype=torch.float64)}
    val = tcosts.diff_norm(arg)
    assert float(val.detach()) == 4.0
    (g,) = torch.autograd.grad(val, arg["prediction"])
    jg = jax.grad(lambda p: jcosts.diff_norm(
        {"prediction": p, "measurement": jnp.zeros((4, 3))}))(jnp.asarray(d))
    np.testing.assert_array_equal(np_of(g), np_of(jg))


def test_zero_pxy_has_finite_zero_subgradient():
    arg = _arg(2, zero_pxy=True)
    tv, tg = _value_and_grads("flow_norm_pxy", arg, False)
    jv, jg = _value_and_grads("flow_norm_pxy", arg, True)
    assert tv == 0.0 == jv
    pxy_grad = tg[KEYS.index("pxy")]
    assert np.isfinite(pxy_grad).all() and not pxy_grad.any()
    np.testing.assert_array_equal(pxy_grad, jg[KEYS.index("pxy")])


@pytest.mark.parametrize("weights", [
    (("diff_norm", 1.0), ("image_gradient", 0.5), ("flow_norm_pxy", 0.1)),
    (("diff_norm", 1.0), ("flow_norm", "inv")),
    (("diff_norm", 2.0), ("image_gradient", ("inv", 0.37))),
])
@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_hybrid_cost(weights, direction):
    arg = _arg(3)
    jfn = jcosts.hybrid_cost(dict(weights), direction)
    tfn = tcosts.hybrid_cost(dict(weights), direction)
    jv, jg = _value_and_grads(jfn, arg, True)
    tv, tg = _value_and_grads(tfn, arg, False)
    assert rel_err(tv, jv) <= 1e-10
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    _, terms = tfn({k: torch.as_tensor(v) for k, v in arg.items()})
    _, jterms = jfn({k: jnp.asarray(v) for k, v in arg.items()})
    assert set(terms) == set(jterms)
    for k in terms:
        assert rel_err(terms[k], jterms[k]) <= 1e-10


def test_hybrid_cost_rejects_unknown_direction():
    with pytest.raises(ValueError):
        tcosts.hybrid_cost({"diff_norm": 1.0}, "sideways")


@pytest.mark.parametrize("name", ["image_variance", "gradient_magnitude",
                                  "normalized_image_variance"])
def test_contrast_cost_value_and_gradient(name):
    """The IWE contrasts of the CMax solver; the variance is ddof 0 as
    ``jnp.var``."""
    rng = np.random.default_rng(4)
    iwe = rng.gamma(2.0, 1.0, (H, W))
    orig = rng.gamma(2.0, 1.0, (H, W))
    jv, jg = jax.value_and_grad(
        lambda a, b: jcosts.functions[name]({"iwe": a, "orig_iwe": b}),
        argnums=(0, 1))(jnp.asarray(iwe), jnp.asarray(orig))
    ti = torch.as_tensor(iwe).requires_grad_(True)
    to = torch.as_tensor(orig).requires_grad_(True)
    tv = tcosts.functions[name]({"iwe": ti, "orig_iwe": to})
    tg = torch.autograd.grad(tv, (ti, to), allow_unused=True)
    assert rel_err(tv, jv) <= 1e-12
    for a, b in zip(tg, jg):
        a = np.zeros(b.shape) if a is None else np_of(a)
        np.testing.assert_allclose(a, np_of(b), rtol=1e-9, atol=1e-15)
