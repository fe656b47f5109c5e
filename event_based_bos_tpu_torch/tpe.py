"""Sequential Tree-structured Parzen Estimator (TPE) sampler.

The port's own copy of the JAX package's ``tpe.py`` (numpy and scipy only):
for the same seed and the same objective values its proposals are the same
bit for bit.

The reference drives its optuna path with ``optuna.samplers.TPESampler``
(``src/solver/generative_max_likelihood.py:215-276``).  TPE is inherently
sequential — each trial's proposal depends on every previous trial's loss —
so it cannot be expressed as one batched device program like the random/grid
samplers in :mod:`.optim`.  This module implements the actual algorithm
(Bergstra et al., "Algorithms for Hyper-Parameter Optimization", NeurIPS
2011) with optuna's default behaviors for continuous box-bounded parameters:

  * ``n_startup_trials = 10`` uniform-random warmup trials,
  * split observations at the ``gamma(n) = min(ceil(0.1 n), 25)`` quantile
    into "below" (good) and "above" (bad) sets,
  * univariate Parzen estimators per parameter (optuna's default
    ``multivariate=False`` — each parameter is modeled independently),
  * each estimator mixes truncated Gaussians at the observations plus a
    wide prior component (``consider_prior=True``: mean at the box center,
    sigma = box width, weight 1),
  * neighbor-distance bandwidths with optuna's "magic clip"
    (``sigma ∈ [width / min(100, 1 + n_obs), width]``),
  * a recency weight ramp once more than 25 observations exist,
  * ``n_ei_candidates = 24`` draws from the "below" estimator scored by
    ``log l(x) − log g(x)``; the best-scoring candidate is evaluated.

The host drives the loop; the objective is typically a tiny device
program evaluated once per trial — the same execution shape as the
reference's optuna study (scipy/optuna on host, torch objective per trial).

Recency-ramp ordering: optuna 2.10's ``_split_observation_pairs`` hands
each Parzen set to the estimator in loss-ascending order, and the ramp of
``default_weights`` applies over that order — so once a set exceeds 25
observations the ramp de-weights its best-loss members, not its oldest.
This module keeps optuna's behavior, as the JAX package does.

Deliberate deviations from optuna (documented, not bug-for-bug):
  * no categorical/log/discrete distributions (the reference only ever
    suggests ``suggest_uniform``, ``gml:241-245``).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np

from .optim import OptResult

__all__ = ["run_tpe", "ParzenEstimator"]

def _norm_cdf(z: np.ndarray) -> np.ndarray:
    from scipy.special import ndtr

    return ndtr(z)


def _default_gamma(n: int) -> int:
    return min(int(np.ceil(0.1 * n)), 25)


def _default_weights(n: int) -> np.ndarray:
    """Optuna's ``default_weights``: flat for ≤25 observations, then a
    linear ramp so old trials fade."""
    if n == 0:
        return np.zeros(0)
    if n <= 25:
        return np.ones(n)
    ramp = np.linspace(1.0 / n, 1.0, n - 25)
    return np.concatenate([ramp, np.ones(25)])


class ParzenEstimator:
    """1-D mixture of truncated Gaussians over ``[low, high]``."""

    def __init__(self, mus: np.ndarray, low: float, high: float,
                 consider_prior: bool = True, prior_weight: float = 1.0):
        mus = np.asarray(mus, np.float64)
        n = len(mus)
        width = high - low
        weights = _default_weights(n)
        if consider_prior:
            mus = np.append(mus, 0.5 * (low + high))
            weights = np.append(weights, prior_weight)
        order = np.argsort(mus)
        sorted_mus = mus[order]
        # neighbor-distance bandwidths with the box edges as sentinels
        ext = np.concatenate([[low], sorted_mus, [high]])
        sigmas_sorted = np.maximum(ext[1:-1] - ext[:-2], ext[2:] - ext[1:-1])
        # magic clip keeps every component usable
        max_sigma = width
        min_sigma = width / min(100.0, 1.0 + len(sorted_mus))
        sigmas_sorted = np.clip(sigmas_sorted, min_sigma, max_sigma)
        if consider_prior:
            # the prior component keeps the full-box bandwidth
            prior_pos = int(np.nonzero(order == n)[0][0])
            sigmas_sorted[prior_pos] = width
        self.mus = sorted_mus
        self.sigmas = sigmas_sorted
        w = weights[order]
        self.weights = w / w.sum()
        self.low = float(low)
        self.high = float(high)
        # truncation normalizer per component
        self._z = (_norm_cdf((self.high - self.mus) / self.sigmas)
                   - _norm_cdf((self.low - self.mus) / self.sigmas))
        self._z = np.maximum(self._z, 1e-300)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        comp = rng.choice(len(self.mus), size=n, p=self.weights)
        mus, sigmas = self.mus[comp], self.sigmas[comp]
        # inverse-CDF truncated normal draw
        a = _norm_cdf((self.low - mus) / sigmas)
        b = _norm_cdf((self.high - mus) / sigmas)
        u = rng.uniform(a, b)
        u = np.clip(u, 1e-12, 1.0 - 1e-12)
        from scipy.special import ndtri  # Φ⁻¹ (scipy ships in the image)

        x = mus + sigmas * ndtri(u)
        return np.clip(x, self.low, self.high)

    def log_pdf(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)[:, None]
        z = (x - self.mus[None, :]) / self.sigmas[None, :]
        log_comp = (-0.5 * z * z
                    - np.log(self.sigmas[None, :] * math.sqrt(2 * math.pi))
                    - np.log(self._z[None, :])
                    + np.log(self.weights[None, :]))
        m = log_comp.max(axis=1, keepdims=True)
        return (m + np.log(np.exp(log_comp - m).sum(axis=1, keepdims=True)))[:, 0]


def _propose(xs: np.ndarray, losses: np.ndarray, t: int, lo: np.ndarray,
             hi: np.ndarray, rng: np.random.Generator,
             n_ei_candidates: int) -> np.ndarray:
    """One adaptive TPE proposal from the first ``t`` observations.

    Mirrors optuna 2.10's ``_split_observation_pairs`` → per-parameter
    ``_ParzenEstimator`` → EI-argmax pipeline: the below/above sets are
    passed in LOSS-ASCENDING order (``np.argsort`` of the losses), which is
    the order the recency weight ramp (:func:`_default_weights`) applies
    over — optuna's exact behavior at n > 25, see the module docstring.
    """
    n_below = _default_gamma(t)
    order = np.argsort(losses[:t], kind="stable")
    below_idx = order[:n_below]
    above_idx = order[n_below:]
    dim = lo.shape[0]
    x = np.empty(dim)
    for d in range(dim):
        l_est = ParzenEstimator(xs[below_idx, d], lo[d], hi[d])
        g_est = ParzenEstimator(xs[above_idx, d], lo[d], hi[d])
        cand = l_est.sample(rng, n_ei_candidates)
        score = l_est.log_pdf(cand) - g_est.log_pdf(cand)
        x[d] = cand[int(np.argmax(score))]
    return x


def run_tpe(
    objective: Callable[[np.ndarray], float],
    bounds: Tuple[Sequence[float], Sequence[float]],
    n_trials: int,
    seed: int = 0,
    n_startup_trials: int = 10,
    n_ei_candidates: int = 24,
) -> OptResult:
    """Sequential TPE minimization over a box; optuna-compatible semantics.

    ``objective`` maps a ``(dim,)`` float array to a scalar loss (host
    callable — wrap a device function).  Returns the same
    :class:`~event_based_bos_tpu_torch.optim.OptResult` contract as the batched
    samplers: best param/loss, per-trial loss ``history``.
    """
    lo = np.asarray(bounds[0], np.float64)
    hi = np.asarray(bounds[1], np.float64)
    dim = lo.shape[0]
    rng = np.random.default_rng(seed)

    xs = np.empty((n_trials, dim))
    losses = np.empty(n_trials)
    for t in range(n_trials):
        if t < n_startup_trials:
            x = rng.uniform(lo, hi)
        else:
            x = _propose(xs, losses, t, lo, hi, rng, n_ei_candidates)
        xs[t] = x
        losses[t] = float(objective(x))

    best = int(np.argmin(losses))
    return OptResult(param=xs[best], loss=losses[best], best_iter=best,
                     history=losses, last_param=xs[-1])
