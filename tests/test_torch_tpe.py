"""The port's own sequential TPE sampler (``tpe.py``) against the JAX
package's.

The port carries a copy (numpy and scipy only): for the same seed and the
same objective values, every proposal must be the same bit for bit,
including past 25 observations, where optuna's recency ramp reweights the
Parzen sets.
"""

import numpy as np
import pytest

import event_based_bos_tpu.tpe as jtpe
import event_based_bos_tpu_torch.tpe as ttpe


def _rugged(x):
    """A bumpy objective, so the trials spread and the sets reorder."""
    x = np.asarray(x, np.float64)
    return float(np.sum((x - 0.4) ** 2) + 0.3 * np.sum(np.sin(5.0 * x)))


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("dim", [2, 3])
def test_proposals_bit_identical_past_the_recency_ramp(seed, dim):
    """60 trials: the "above" set holds up to 54 observations, past the 25
    where the ramp starts."""
    bounds = ([-2.0] * dim, [3.0] * dim)
    got_x, want_x = [], []

    def recorder(store):
        def objective(x):
            store.append(np.array(x))
            return _rugged(x)
        return objective

    got = ttpe.run_tpe(recorder(got_x), bounds, 60, seed=seed)
    want = jtpe.run_tpe(recorder(want_x), bounds, 60, seed=seed)
    assert np.array_equal(np.stack(got_x), np.stack(want_x))
    assert np.array_equal(got.history, want.history)
    assert np.array_equal(got.param, want.param)
    assert got.best_iter == want.best_iter and got.loss == want.loss


def test_parzen_estimator_matches():
    rng = np.random.default_rng(3)
    mus = rng.uniform(-1, 2, 40)
    a = ttpe.ParzenEstimator(mus, -1.0, 2.0)
    b = jtpe.ParzenEstimator(mus, -1.0, 2.0)
    for k in ("mus", "sigmas", "weights"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    xs = np.linspace(-1, 2, 17)
    assert np.array_equal(a.log_pdf(xs), b.log_pdf(xs))
    assert np.array_equal(a.sample(np.random.default_rng(1), 24),
                          b.sample(np.random.default_rng(1), 24))


def test_result_is_the_port_optresult():
    from event_based_bos_tpu_torch.optim import OptResult

    res = ttpe.run_tpe(_rugged, ([-1.0], [1.0]), 12, seed=1)
    assert isinstance(res, OptResult)
    assert res.history.shape == (12,)
    assert res.best_iter == int(np.argmin(res.history))
