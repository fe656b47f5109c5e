"""On-device optimization loops.

PyTorch counterpart of the JAX package's ``optim.py`` (``lax.scan`` loops
over optax there):

  * :func:`run_first_order` (:class:`FirstOrderLoop`) — the torch-optimizer
    names of the reference, each written out as optax 0.2.6 computes it,
    with optax's staircase ``exponential_decay`` schedule and best-iterate
    tracking.  The loop is one step function over state held in device
    tensors, with **no host synchronisation**: on the card it is captured
    once as a CUDA graph and replayed (:mod:`.graphs`, the counterpart of
    the JAX package's jitted ``lax.scan``), on the CPU it runs in a Python
    loop.  An objective that returns a vector of losses is a batch of
    independent problems (one per leading row of ``x``): the gradient of
    their sum is each row's own gradient, and the best iterate is tracked
    per row.
  * :func:`run_scipy_method` — the scipy names, per family:
    quasi-Newton → :func:`run_lbfgs` (optax's L-BFGS with its zoom line
    search), derivative-free → :func:`run_nelder_mead` (a branchless
    simplex), Hessian/HVP → :func:`run_newton_cg` (CG on Hessian-vector
    products of a double backward).
  * :func:`run_sampler` — the random and grid samplers over a box, and the
    two-stage stand-in the JAX package runs for ``TPE`` inside a batched
    program (the sequential TPE study is :mod:`.tpe`).

The per-step scalars of the first-order methods depend only on the step
index: they are tabulated once per loop on the device and read by the step
from its counter.  The zoom line search's loop depends on the data: its
scalars live on the host in float64 and each of its function evaluations
is one host read (``OptResult.host_reads`` counts them).
"""

from __future__ import annotations

import logging
import math
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import graphs

__all__ = ["OptResult", "Adam", "AdamW", "NAdam", "Adamax", "RAdam",
           "Adagrad", "Adadelta", "RMSprop", "SGD", "make_optimizer",
           "FirstOrderLoop", "run_first_order", "run_lbfgs",
           "run_nelder_mead", "run_newton_cg", "run_scipy_method", "run_sampler", "FIRST_ORDER_METHODS",
           "QUASI_NEWTON_METHODS", "DERIVATIVE_FREE_METHODS",
           "HESSIAN_METHODS", "SCIPY_METHODS", "SAMPLER_METHODS"]

logger = logging.getLogger(__name__)


class OptResult(Dict[str, Any]):
    """Dict result with attribute access (param/loss/best_iter/history)."""

    __getattr__ = dict.__getitem__


# ---------------------------------------------------------------------------
# First-order methods (optax 0.2.6 with a staircase schedule)
# ---------------------------------------------------------------------------

class Adam:
    """optax ``adam(exponential_decay(lr, lr_step, lr_decay, staircase))``.

    ``lr`` may be a Python number or a 0-dim tensor.  Every method steps
    ``x ← x − lr(count) · direction``.  The scalars of a step (the learning
    rate and the family's bias corrections) depend only on its index
    ``count``: :meth:`step_table` tabulates them for a whole loop on the
    device, row ``count`` = ``[−lr(count), *scalars(count)]``, and
    :meth:`step` reads them from that row, so that one step function (and
    one captured graph of it) serves every index.  Subclasses replace
    :meth:`init`, :meth:`scalars` and :meth:`direction`, and list in
    ``divisors`` the scalars that the moments are divided by.
    """

    #: indices of :meth:`scalars` that divide (see :meth:`step_table`)
    divisors: Tuple[int, ...] = (0, 1)

    def __init__(self, lr, lr_step: int, lr_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr = lr
        self.lr_step = max(lr_step, 1)
        self.lr_decay = lr_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def learning_rate(self, count: int):
        """optax's schedule value for step ``count``.  optax evaluates it in
        float32 (its step counter is int32), so a Python number is rounded
        the same way; a tensor ``lr`` is used as it is."""
        p = math.floor(count / self.lr_step)
        if torch.is_tensor(self.lr):
            return self.lr if count <= 0 else self.lr * self.lr_decay ** p
        lr = np.float32(self.lr)
        if count > 0:
            lr = lr * np.power(np.float32(self.lr_decay), np.float32(p))
        return float(lr)

    def scalars(self, count: int) -> Tuple[float, ...]:
        """The family's scalars of step ``count`` besides the learning
        rate: Adam's bias corrections ``1 − b1^c`` and ``1 − b2^c``, c =
        count + 1."""
        c = count + 1
        return (1 - self.b1 ** c, 1 - self.b2 ** c)

    def step_table(self, n_iter: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
        """``[n_iter, 1 + k]`` in ``dtype`` on ``device``: row ``count`` is
        ``−lr(count)`` and :meth:`scalars` of ``count``, each rounded to
        ``dtype``.  A divisor ``s`` is held as ``1 / s`` (in float64,
        then rounded) and multiplies: the division of a tensor by a Python
        number as PyTorch's CUDA kernels compute it (and the port's loop
        did on the card before its scalars moved to the device), within
        an ulp of optax's division."""
        k = len(self.scalars(0))
        rows = np.asarray([self.scalars(c) for c in range(n_iter)],
                          np.float64).reshape(n_iter, k)
        cols = list(self.divisors)
        rows[:, cols] = 1.0 / rows[:, cols]
        rows = torch.as_tensor(rows).to(dtype)
        if torch.is_tensor(self.lr):
            factors = [1.0 if c <= 0 else
                       self.lr_decay ** math.floor(c / self.lr_step)
                       for c in range(n_iter)]
            lr = self.lr.detach() * torch.as_tensor(
                factors, dtype=self.lr.dtype).to(self.lr.device)
            neg_lr = (-lr).to(device=device, dtype=dtype)
        else:
            neg_lr = torch.as_tensor(
                [-self.learning_rate(c) for c in range(n_iter)],
                dtype=torch.float64).to(device=device, dtype=dtype)
        return torch.cat([neg_lr[:, None], rows.to(device)], dim=1)

    def init(self, x: torch.Tensor):
        return {"mu": torch.zeros_like(x), "nu": torch.zeros_like(x)}

    def _moments(self, grad, state):
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * grad + b1 * state["mu"]
        nu = (1 - b2) * (grad * grad) + b2 * state["nu"]
        state["mu"], state["nu"] = mu, nu
        return mu, nu

    def direction(self, x, grad, state, s) -> torch.Tensor:
        """The update before the learning rate (optax's chain up to
        ``scale_by_learning_rate``), with ``s`` the step's table entries
        (0-dim tensors: the :meth:`scalars`, divisors as reciprocals);
        rebinds ``state``'s entries to the new state."""
        mu, nu = self._moments(grad, state)
        inv_bc1, inv_bc2 = s
        return (mu * inv_bc1) / (torch.sqrt(nu * inv_bc2) + self.eps)

    def step(self, x: torch.Tensor, grad: torch.Tensor, state: dict,
             row: torch.Tensor) -> torch.Tensor:
        """One update from the step's table row ``row`` (see
        :meth:`step_table`); returns the new iterate and rebinds ``state``'s
        entries to the new state."""
        return x + row[0] * self.direction(x, grad, state, row[1:])


class AdamW(Adam):
    """optax ``adamw``: Adam plus ``1e-4 · x`` before the learning rate."""

    weight_decay = 1e-4

    def direction(self, x, grad, state, s):
        return super().direction(x, grad, state, s) + self.weight_decay * x


class NAdam(Adam):
    """optax ``nadam`` (Adam with Nesterov momentum)."""

    divisors = (0, 1, 2)

    def scalars(self, count):
        c = count + 1
        return (1 - self.b1 ** (c + 1), 1 - self.b1 ** c, 1 - self.b2 ** c)

    def direction(self, x, grad, state, s):
        mu, nu = self._moments(grad, state)
        inv_bc1_next, inv_bc1, inv_bc2 = s
        b1 = self.b1
        mu_hat = b1 * (mu * inv_bc1_next) + (1 - b1) * (grad * inv_bc1)
        return mu_hat / (torch.sqrt(nu * inv_bc2) + self.eps)


class Adamax(Adam):
    """optax ``adamax``: the infinity-norm moment ``max(|g| + eps, b2·ν)``,
    no bias correction of ν."""

    divisors = (0,)

    def scalars(self, count):
        return (1 - self.b1 ** (count + 1),)

    def direction(self, x, grad, state, s):
        mu = (1 - self.b1) * grad + self.b1 * state["mu"]
        nu = torch.maximum(torch.abs(grad) + self.eps,
                           self.b2 * state["nu"])
        state["mu"], state["nu"] = mu, nu
        return (mu * s[0]) / nu


class RAdam(Adam):
    """optax ``radam`` (threshold 5): the rectified update once the
    variance is tractable, the bias-corrected momentum before.  Which of
    the two a step takes depends only on its index: a flag of the step
    table selects it on the device."""

    threshold = 5.0

    def scalars(self, count):
        c = count + 1
        b2t = self.b2 ** c
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        ro = ro_inf - 2 * c * b2t / (1 - b2t)
        if ro < self.threshold:
            r, rectified = 0.0, 0.0
        else:
            r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                          / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            rectified = 1.0
        return (1 - self.b1 ** c, 1 - b2t, r, rectified)

    def direction(self, x, grad, state, s):
        mu, nu = self._moments(grad, state)
        inv_bc1, inv_bc2, r, rectified = s
        mu_hat = mu * inv_bc1
        return torch.where(rectified != 0,
                           r * mu_hat / (torch.sqrt(nu * inv_bc2) + self.eps),
                           mu_hat)


class Adagrad(Adam):
    """optax ``adagrad``: the sum of squares starts at 0.1, eps 1e-7 inside
    the square root."""

    divisors = ()

    def scalars(self, count):
        return ()

    def init(self, x):
        return {"sum_sq": torch.full_like(x, 0.1)}

    def direction(self, x, grad, state, s):
        sq = grad * grad + state["sum_sq"]
        state["sum_sq"] = sq
        return torch.where(sq > 0, torch.rsqrt(sq + 1e-7), 0.0) * grad


class Adadelta(Adam):
    """optax ``adadelta`` (rho 0.9, eps 1e-6) with the learning rate."""

    rho, delta_eps = 0.9, 1e-6

    divisors = ()

    def scalars(self, count):
        return ()

    def init(self, x):
        return {"e_g": torch.zeros_like(x), "e_x": torch.zeros_like(x)}

    def direction(self, x, grad, state, s):
        rho, eps = self.rho, self.delta_eps
        e_g = (1 - rho) * (grad * grad) + rho * state["e_g"]
        u = (torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps)) * grad
        state["e_g"] = e_g
        state["e_x"] = (1 - rho) * (u * u) + rho * state["e_x"]
        return u


class RMSprop(Adam):
    """optax ``rmsprop`` (decay 0.9, eps 1e-8 inside the square root, no
    momentum)."""

    divisors = ()

    def scalars(self, count):
        return ()

    def init(self, x):
        return {"nu": torch.zeros_like(x)}

    def direction(self, x, grad, state, s):
        nu = (1 - 0.9) * (grad * grad) + 0.9 * state["nu"]
        state["nu"] = nu
        return torch.rsqrt(nu + 1e-8) * grad


class SGD(Adam):
    """optax ``sgd`` (no momentum)."""

    divisors = ()

    def scalars(self, count):
        return ()

    def init(self, x):
        return {}

    def direction(self, x, grad, state, s):
        return grad


#: torch-optimizer names of the reference → the port's optax equivalents
#: (``ASGD`` is plain SGD, as in the JAX package; ``Rprop`` fails there)
FIRST_ORDER_METHODS = {
    "Adam": Adam, "AdamW": AdamW, "Adamax": Adamax, "NAdam": NAdam,
    "RAdam": RAdam, "Adagrad": Adagrad, "Adadelta": Adadelta,
    "RMSprop": RMSprop, "SGD": SGD, "ASGD": SGD, "Rprop": None,
}

# scipy.optimize names of the reference, routed per family
QUASI_NEWTON_METHODS = ("BFGS", "L-BFGS-B", "LBFGS", "CG", "SLSQP")
DERIVATIVE_FREE_METHODS = ("Nelder-Mead", "Powell")
HESSIAN_METHODS = ("Newton-CG", "TNC", "trust-constr")
SCIPY_METHODS = (QUASI_NEWTON_METHODS + DERIVATIVE_FREE_METHODS
                 + HESSIAN_METHODS)
SAMPLER_METHODS = ("random", "grid", "uniform", "TPE")


def make_optimizer(method: str, lr, lr_step: int, lr_decay: float) -> Adam:
    """The optimizer for ``method`` with a staircase step decay (lr drops by
    ``lr_decay`` every ``lr_step`` steps)."""
    if method not in FIRST_ORDER_METHODS:
        raise KeyError(f"Unsupported first-order method {method!r}")
    if FIRST_ORDER_METHODS[method] is None:
        # optax.rprop takes a float learning rate, not the schedule the
        # reference's StepLR maps to: the JAX package fails here too
        raise TypeError("Rprop cannot run with a learning-rate schedule "
                        "(optax.rprop fills its step sizes from a float); "
                        "the JAX package raises for it as well")
    return FIRST_ORDER_METHODS[method](lr, lr_step, lr_decay)


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``mask`` (the loss's shape) broadcast over the trailing axes of
    ``x``."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


class FirstOrderLoop:
    """A first-order solve of ``objective``: its loop state, its step and
    its route, reusable for further solves of the same shapes.

    The state lives in tensors allocated once, before the first update:
    the iterate ``x``, the optimizer state, the best iterate, loss and
    step, the loss and per-term histories, the ``record_every`` buffer,
    the step table (:meth:`Adam.step_table`) and a device step counter.
    One step (:meth:`_step`) evaluates the objective and its gradient at
    ``x`` and updates all of it in place, reading its index from the
    counter, so the same step runs at every index: on the card as a
    replayed CUDA graph (:class:`~event_based_bos_tpu_torch.graphs.StepGraph`;
    op by op inside :func:`~event_based_bos_tpu_torch.graphs.eager_loops`),
    on the CPU in a Python loop.  The first solve's first evaluation, at ``x0``, gives the
    loss's shape and the per-term names that the histories need.

    :meth:`run` returns copies of the outputs, so a later run (which
    overwrites the state) leaves them as they are.  The objective must read
    its constants from tensors that stay where they are between runs: a
    captured step reads the same addresses at every replay.
    """

    def __init__(self, objective: Callable, n_iter: int,
                 method: str = "Adam", lr=0.05, lr_decay: float = 0.1,
                 lr_step: Optional[int] = None, track_best: bool = True,
                 has_aux: bool = False,
                 bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 record_every: int = 0):
        self.objective = objective
        self.n_iter = n_iter
        self.opt = make_optimizer(method, lr,
                                  n_iter if lr_step is None else lr_step,
                                  lr_decay)
        self.track_best = track_best
        self.has_aux = has_aux
        self.bounds = bounds
        self.record_every = record_every
        self.graph: Optional[graphs.StepGraph] = None
        self._c: Optional[SimpleNamespace] = None

    # -- the step ------------------------------------------------------------
    def _evaluate(self, x: torch.Tensor):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = self.objective(xg)
            loss, aux = out if self.has_aux else (out, None)
            (grad,) = torch.autograd.grad(
                loss if loss.dim() == 0 else loss.sum(), xg)
        return loss.detach(), aux, grad

    def _update(self, loss, aux, grad) -> None:
        c = self._c
        idx = c.count
        c.history.index_copy_(0, idx, loss.to(c.history.dtype)[None])
        if c.aux_history is not None:
            for k, h in c.aux_history.items():
                h.index_copy_(0, idx, aux[k].detach().to(h.dtype).reshape(1))
        better = loss < c.best_loss
        if self.track_best:
            c.best_x.copy_(torch.where(_rows(better, c.x), c.x, c.best_x))
        c.best_it.copy_(torch.where(better, idx.to(torch.int32)[0],
                                    c.best_it))
        c.best_loss.copy_(torch.minimum(loss, c.best_loss))
        if self.record_every > 0:
            # every k-th iterate, by a select on the device (as JAX's scan)
            slot = torch.div(idx, self.record_every, rounding_mode="floor")
            keep = (idx % self.record_every == 0)[0]
            kept = c.params_history.index_select(0, slot)[0]
            c.params_history.index_copy_(
                0, slot, torch.where(keep, c.x, kept)[None])
        row = c.table.index_select(0, idx)[0]
        state = dict(c.state)
        x_new = self.opt.step(c.x, grad, state, row)
        if self.bounds is not None:
            x_new = torch.clamp(x_new, self.bounds[0], self.bounds[1])
        for k, v in state.items():
            c.state[k].copy_(v)
        c.x.copy_(x_new)
        c.count.add_(1)

    def _step(self) -> None:
        self._update(*self._evaluate(self._c.x))

    # -- state ---------------------------------------------------------------
    def _allocate(self, x: torch.Tensor, loss: torch.Tensor, aux) -> None:
        dev, dt = x.device, x.dtype
        n = self.n_iter
        n_rec = -(-n // self.record_every) if self.record_every > 0 else 0
        self._c = SimpleNamespace(
            x=x,
            state=self.opt.init(x),
            best_x=x.clone() if self.track_best else None,
            best_loss=torch.full(loss.shape, math.inf, device=dev,
                                 dtype=torch.promote_types(loss.dtype, dt)),
            best_it=torch.zeros(loss.shape, dtype=torch.int32, device=dev),
            history=torch.empty((n,) + tuple(loss.shape), dtype=dt,
                                device=dev),
            aux_history=(None if aux is None else
                         {k: torch.empty((n,), dtype=v.dtype, device=dev)
                          for k, v in aux.items()}),
            params_history=torch.zeros((n_rec,) + tuple(x.shape), dtype=dt,
                                       device=dev),
            table=self.opt.step_table(n, dt, dev),
            count=torch.zeros((1,), dtype=torch.int64, device=dev))

    def _reset(self, x0: torch.Tensor) -> None:
        c = self._c
        if (x0.shape != c.x.shape or x0.dtype != c.x.dtype
                or x0.device != c.x.device):
            raise ValueError(
                f"this loop solves for a {tuple(c.x.shape)} {c.x.dtype} "
                f"iterate on {c.x.device}, got {tuple(x0.shape)} "
                f"{x0.dtype} on {x0.device}")
        c.x.copy_(x0)
        for k, v in self.opt.init(c.x).items():
            c.state[k].copy_(v)
        if self.track_best:
            c.best_x.copy_(x0)
        c.best_loss.fill_(math.inf)
        c.best_it.zero_()
        c.params_history.zero_()
        c.count.zero_()

    def set_learning_rate(self, lr) -> None:
        """Solve with learning rate ``lr`` from the next run on (the step
        table is rewritten in place)."""
        self.opt.lr = lr
        if self._c is not None:
            self._c.table.copy_(self.opt.step_table(
                self.n_iter, self._c.table.dtype, self._c.table.device))

    # -- the solve -----------------------------------------------------------
    def run(self, x0: torch.Tensor) -> OptResult:
        """``n_iter`` steps from ``x0``; returns copies of the outputs (see
        :func:`run_first_order`)."""
        if self.n_iter <= 0:
            return self._empty(x0)
        if self._c is None:
            x = x0.detach().clone()
            loss, aux, grad = self._evaluate(x)
            self._allocate(x, loss, aux)
            self._update(loss, aux, grad)
            remaining = self.n_iter - 1
        else:
            self._reset(x0.detach())
            remaining = self.n_iter
        dev = self._c.x.device
        if graphs.graph_route(dev):
            if self.graph is None:
                self.graph = graphs.StepGraph(self._step, dev)
            self.graph.run(remaining)
        else:
            for _ in range(remaining):
                self._step()
        return self._result()

    def _result(self) -> OptResult:
        c = self._c
        param = c.best_x if self.track_best else c.x
        return OptResult(
            param=param.clone(), loss=c.best_loss.clone(),
            best_iter=c.best_it.clone(), history=c.history.clone(),
            aux_history=(None if c.aux_history is None else
                         {k: v.clone() for k, v in c.aux_history.items()}),
            last_param=c.x.clone(),
            params_history=(c.params_history.clone()
                            if self.record_every > 0 else None))

    def _empty(self, x0: torch.Tensor) -> OptResult:
        dev, dt = x0.device, x0.dtype
        x = x0.detach().clone()
        return OptResult(
            param=x, loss=torch.full((), math.inf, dtype=dt, device=dev),
            best_iter=torch.zeros((), dtype=torch.int32, device=dev),
            history=torch.empty((0,), dtype=dt, device=dev),
            aux_history=None, last_param=x,
            params_history=(torch.zeros((0,) + tuple(x0.shape), dtype=dt,
                                        device=dev)
                            if self.record_every > 0 else None))


def run_first_order(objective: Callable, x0: torch.Tensor, n_iter: int,
                    method: str = "Adam", lr=0.05, lr_decay: float = 0.1,
                    lr_step: Optional[int] = None, track_best: bool = True,
                    has_aux: bool = False,
                    bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    record_every: int = 0) -> OptResult:
    """Run ``n_iter`` optimizer steps on ``objective(x)``.

    Returns the best-loss iterate (``track_best``, strict ``<``, by value)
    or the final one, the best loss and its step, the ``[n_iter]`` loss
    history and, with ``has_aux`` (the objective returns ``(loss, aux)``), a
    dict of ``[n_iter]`` per-term histories.  ``bounds = (lo, hi)`` projects
    each iterate onto the box; ``record_every = k > 0`` also returns every
    k-th iterate as ``params_history``.  A loss of shape ``[n]`` makes the
    rows of ``x`` independent problems: the history is ``[n_iter, n]`` and
    the best loss, step and iterate are per row.

    One :class:`FirstOrderLoop`, run once: on the card its step is captured
    and replayed, on the CPU it runs in a Python loop.
    """
    loop = FirstOrderLoop(objective, n_iter, method, lr, lr_decay, lr_step,
                          track_best, has_aux, bounds, record_every)
    try:
        return loop.run(x0)
    finally:
        # the loop and its graph refer to each other: drop the graph (and
        # its memory pool) now, not when the collector next runs
        loop.graph = None


# ---------------------------------------------------------------------------
# L-BFGS with optax's zoom line search
# ---------------------------------------------------------------------------

def _value_and_grad(objective, x):
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = objective(xg)
        (grad,) = torch.autograd.grad(loss, xg)
    return loss.detach(), grad


def _host_pair(a: torch.Tensor, b: torch.Tensor):
    """Two device scalars as float64 numbers, in one copy to the host."""
    v = torch.stack([a.to(torch.float64), b.to(torch.float64)]).cpu().numpy()
    return np.float64(v[0]), np.float64(v[1])


def _lbfgs_direction(grad, x, mem, memory_size: int):
    """optax ``scale_by_lbfgs`` (scaled initial preconditioner): update the
    memory with the last step's differences, return ``P_k · grad``.
    ``mem`` holds the device state and is updated in place."""
    count = mem["count"]
    memory_idx = count % memory_size
    prev_idx = (count - 1) % memory_size
    if count > 0:
        diff_p = x - mem["params"]
        diff_u = grad - mem["updates"]
        vdot = torch.dot(diff_u.reshape(-1), diff_p.reshape(-1))
        weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
        mem["dp"][prev_idx] = diff_p
        mem["du"][prev_idx] = diff_u
        mem["rho"][prev_idx] = weight
        num = torch.dot(diff_u.reshape(-1), diff_p.reshape(-1))
        den = torch.sum(diff_u * diff_u)
        scale = torch.where(den > 0.0, num / den, 1.0)
    else:
        # the first step: a capped reciprocal of the gradient norm
        scale = torch.clamp(1.0 / torch.sqrt(torch.sum(grad * grad)),
                            max=1.0)
        mem["rho"][prev_idx] = 0.0
    indices = [(memory_idx + j) % memory_size for j in range(memory_size)]
    vec = grad
    alphas = {}
    for idx in reversed(indices):
        alpha = mem["rho"][idx] * torch.dot(mem["dp"][idx].reshape(-1),
                                            vec.reshape(-1))
        vec = vec - alpha * mem["du"][idx]
        alphas[idx] = alpha
    vec = scale * vec
    for idx in indices:
        beta = mem["rho"][idx] * torch.dot(mem["du"][idx].reshape(-1),
                                           vec.reshape(-1))
        vec = vec + (alphas[idx] - beta) * mem["dp"][idx]
    mem["count"] = count + 1
    mem["params"], mem["updates"] = x, grad
    return vec


def _max_nan(a, b):
    """``jnp.maximum`` of two numbers: NaN if either is NaN."""
    return np.maximum(np.float64(a), np.float64(b))


def _min_nan(a, b):
    """``jnp.minimum`` of two numbers: NaN if either is NaN."""
    return np.minimum(np.float64(a), np.float64(b))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope ``fpa`` at ``a`` (NaN when there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc ** 2 * v0 + -(db ** 2) * v1) / denom
    B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    ``fpa`` at ``a``."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _zoom_linesearch(objective, x, direction, value, slope,
                     max_steps: int = 20, slope_rtol: float = 1e-4,
                     curv_rtol: float = 0.9, approx_dec_rtol: float = 1e-6,
                     increase_factor: float = 2.0,
                     interval_threshold: float = 1e-5):
    """optax ``zoom_linesearch`` (interval search, then zoom by cubic,
    quadratic or bisection steps; ``tol = 0``, no maximal step size, first
    guess 1) from ``value`` and ``slope`` at ``x`` along ``direction``.
    Returns ``(stepsize, host_reads)``: each trial step is one evaluation
    and one read of its value and slope."""
    f64 = np.float64
    value_init, slope_init = f64(value), f64(slope)
    reads = 0

    def on_line(stepsize):
        nonlocal reads
        v, g = _value_and_grad(objective, x + stepsize * direction)
        reads += 1
        return _host_pair(v, torch.dot(g.reshape(-1), direction.reshape(-1)))

    def errors(stepsize, v, s):
        dec = v - value_init - slope_rtol * stepsize * slope_init
        approx = _max_nan(s - (2 * slope_rtol - 1.0) * slope_init,
                         v - value_init - approx_dec_rtol * abs(value_init))
        dec = _max_nan(_min_nan(approx, dec), f64(0.0))
        dec = f64(np.inf) if np.isnan(dec) else dec
        curv = _max_nan(abs(s) - curv_rtol * abs(slope_init), f64(0.0))
        curv = f64(np.inf) if np.isnan(curv) else curv
        return dec, curv

    st = dict(count=0, stepsize=f64(0.0), value=value_init,
              slope=slope_init,
              interval_found=False, low=f64(0.0), value_low=value_init,
              slope_low=slope_init, high=f64(0.0), value_high=value_init,
              slope_high=slope_init, cubic_ref=f64(0.0),
              value_cubic_ref=value_init, safe_stepsize=f64(0.0),
              safe_value=value_init)
    with np.errstate(all="ignore"):
        while True:
            it = st["count"]
            if not st["interval_found"]:
                new = (f64(1.0) if it == 0
                       else increase_factor * st["stepsize"])
                v, s = on_line(new)
                dec, curv = errors(new, v, s)
                error = _max_nan(dec, curv)
                if dec <= 0.0:
                    st["safe_stepsize"], st["safe_value"] = new, v
                set_high = (dec > 0.0) or (v >= st["value"] and it > 0)
                set_low = (s >= 0.0) and not set_high
                prev = (st["stepsize"], st["value"], st["slope"])
                if set_low:
                    lo_, hi_ = (new, v, s), prev
                else:
                    lo_, hi_ = prev, (new, v, s)
                st["low"], st["value_low"], st["slope_low"] = lo_
                st["high"], st["value_high"], st["slope_high"] = hi_
                st["cubic_ref"], st["value_cubic_ref"] = lo_[0], lo_[1]
                st["interval_found"] = bool(set_high or set_low
                                            or error <= 0.0)
                done = error <= 0.0
                failed = (it + 1 >= max_steps) and not done
            else:
                low, high = st["low"], st["high"]
                vlow, vhigh = st["value_low"], st["value_high"]
                delta = abs(high - low)
                left, right = _min_nan(high, low), _max_nan(high, low)
                cubic = _cubicmin(low, vlow, st["slope_low"], high, vhigh,
                                  st["cubic_ref"], st["value_cubic_ref"])
                use_cubic = (cubic > left + 0.2 * delta
                             and cubic < right - 0.2 * delta)
                quad = _quadmin(low, vlow, st["slope_low"], high, vhigh)
                use_quad = (not use_cubic and quad > left + 0.1 * delta
                            and quad < right - 0.1 * delta)
                new = (cubic if use_cubic else quad if use_quad
                       else (low + high) / 2.0)
                v, s = on_line(new)
                dec, curv = errors(new, v, s)
                error = _max_nan(dec, curv)
                if dec <= 0.0 and v < st["safe_value"]:
                    st["safe_stepsize"], st["safe_value"] = new, v
                done = error <= 0.0
                set_high_mid = (dec > 0.0) or (v >= vlow)
                set_high_low = (s * (high - low) >= 0.0) and not set_high_mid
                hi_ = (new, v, s) if set_high_mid else (
                    high, vhigh, st["slope_high"])
                if set_high_low:
                    hi_ = (low, vlow, st["slope_low"])
                lo_ = (low, vlow, st["slope_low"]) if set_high_mid else (
                    new, v, s)
                if set_high_mid or set_high_low:
                    st["cubic_ref"], st["value_cubic_ref"] = high, vhigh
                else:
                    st["cubic_ref"], st["value_cubic_ref"] = low, vlow
                st["low"], st["value_low"], st["slope_low"] = lo_
                st["high"], st["value_high"], st["slope_high"] = hi_
                failed = ((it + 1 >= max_steps)
                          or (delta <= interval_threshold
                              and st["safe_stepsize"] > 0.0)) and not done
            st.update(count=it + 1, stepsize=new, value=v, slope=s)
            if failed:
                # the best step with sufficient decrease, if any
                if st["safe_stepsize"] > 0.0 or np.isinf(dec):
                    st["stepsize"] = st["safe_stepsize"]
            if done or failed:
                return float(st["stepsize"]), reads


def run_lbfgs(objective: Callable, x0: torch.Tensor, n_iter: int = 100,
              memory_size: int = 10,
              bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> OptResult:
    """optax ``lbfgs(memory_size=10)`` with its zoom line search (at most 20
    evaluations a step, first guess 1) and best-iterate tracking.

    ``bounds = (lo, hi)`` projects every iterate onto the box.  The line
    search runs on the host from one read per evaluation; each iteration
    also reads its loss and slope (``host_reads`` counts every read).
    """
    dev, dt = x0.device, x0.dtype
    x = x0.detach().clone()
    mem = {"count": 0,
           "dp": torch.zeros((memory_size,) + tuple(x.shape), dtype=dt,
                             device=dev),
           "du": torch.zeros((memory_size,) + tuple(x.shape), dtype=dt,
                             device=dev),
           "rho": torch.zeros((memory_size,), dtype=dt, device=dev)}
    losses = []
    best_x, best_loss, best_it = x, np.float64(np.inf), 0
    reads = 0
    for it in range(n_iter):
        loss, grad = _value_and_grad(objective, x)
        direction = -_lbfgs_direction(grad, x, mem, memory_size)
        value, slope = _host_pair(loss, torch.dot(direction.reshape(-1),
                                                  grad.reshape(-1)))
        reads += 1
        losses.append(value)
        if value < best_loss:
            best_x, best_it = x, it
        best_loss = _min_nan(value, best_loss)
        stepsize, n = _zoom_linesearch(objective, x, direction, value, slope)
        reads += n
        x = x + stepsize * direction
        if bounds is not None:
            x = torch.clamp(x, bounds[0], bounds[1])
    with torch.no_grad():
        final = float(objective(x))
    reads += 1
    use_final = final < best_loss
    history = torch.tensor(losses, dtype=torch.float64).to(device=dev,
                                                           dtype=dt)
    return OptResult(
        param=x if use_final else best_x,
        loss=torch.tensor(float(_min_nan(final, best_loss)), dtype=dt,
                          device=dev),
        best_iter=torch.tensor(n_iter - 1 if use_final else best_it,
                               dtype=torch.int32, device=dev),
        history=history, last_param=x, host_reads=reads)


# ---------------------------------------------------------------------------
# Nelder-Mead and Newton-CG
# ---------------------------------------------------------------------------

def _evaluate(objective, xs: torch.Tensor) -> torch.Tensor:
    """``objective`` at each row of ``xs`` (no gradient), stacked."""
    with torch.no_grad():
        return torch.stack([objective(x) for x in xs])


def run_nelder_mead(objective: Callable, x0: torch.Tensor, n_iter: int = 100,
                    bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> OptResult:
    """Derivative-free Nelder-Mead simplex, branchless, on the device.

    Standard coefficients (ρ=1, χ=2, ψ=0.5, σ=0.5) and scipy's initial
    simplex (x0 ± 5 % per coordinate, 0.00025 for zero coordinates; with
    ``bounds``, toward whichever side of the box moves).  Every iteration
    evaluates reflection, expansion, both contractions and the shrunk
    simplex and selects with ``where``; the simplex is ordered with a
    stable sort, so ties keep their order.
    """
    d = x0.shape[0]
    rho, chi, psi, sigma = 1.0, 2.0, 0.5, 0.5

    def project(x):
        return (torch.clamp(x, bounds[0], bounds[1]) if bounds is not None
                else x)

    x0 = project(x0.detach())
    pert = torch.where(x0 != 0, x0 * 0.05, 0.00025)
    if bounds is not None:
        up = torch.clamp(x0 + pert, bounds[0], bounds[1])
        down = torch.clamp(x0 - pert, bounds[0], bounds[1])
        diag_vals = torch.where(torch.abs(up - x0) > 0, up, down)
    else:
        diag_vals = x0 + pert
    vertices = x0.repeat(d, 1)
    idx = torch.arange(d, device=x0.device)
    vertices[idx, idx] = diag_vals
    simplex = torch.cat([x0[None], vertices], dim=0)
    fvals = _evaluate(objective, simplex)
    history = torch.empty((n_iter,), dtype=fvals.dtype, device=x0.device)

    for it in range(n_iter):
        order = torch.argsort(fvals, stable=True)
        simplex = simplex[order]
        fvals = fvals[order]
        xbar = torch.mean(simplex[:d], dim=0)
        worst = simplex[d]
        xr = project(xbar + rho * (xbar - worst))
        xe = project(xbar + rho * chi * (xbar - worst))
        xoc = project(xbar + psi * rho * (xbar - worst))
        xic = project(xbar - psi * (xbar - worst))
        fr, fe, foc, fic = _evaluate(objective, torch.stack([xr, xe, xoc,
                                                             xic]))

        expand = fr < fvals[0]
        take_e = expand & (fe < fr)
        new_x = torch.where(take_e, xe, xr)
        new_f = torch.where(take_e, fe, fr)
        use_oc = (fr >= fvals[d - 1]) & (fr < fvals[d])
        new_x = torch.where(use_oc, xoc, new_x)
        new_f = torch.where(use_oc, foc, new_f)
        use_ic = fr >= fvals[d]
        new_x = torch.where(use_ic, xic, new_x)
        new_f = torch.where(use_ic, fic, new_f)
        shrink = (use_oc & (foc > fr)) | (use_ic & (fic >= fvals[d]))

        replaced = simplex.clone()
        replaced[d] = new_x
        freplaced = fvals.clone()
        freplaced[d] = new_f
        shrunk = project(simplex[0][None] + sigma * (simplex - simplex[0]))
        fshrunk = _evaluate(objective, shrunk)
        simplex = torch.where(shrink, shrunk, replaced)
        fvals = torch.where(shrink, fshrunk, freplaced)
        history[it] = torch.min(fvals)
    best = torch.argmin(fvals)
    return OptResult(param=simplex[best], loss=fvals[best],
                     best_iter=torch.tensor(n_iter - 1, dtype=torch.int32,
                                            device=x0.device),
                     history=history, last_param=simplex[best])


def _cg(hvp: Callable, b: torch.Tensor, maxiter: int, tol: float = 1e-5,
        atol: float = 0.0) -> torch.Tensor:
    """``jax.scipy.sparse.linalg.cg`` from x0 = 0: stop at
    ``rs ≤ max(tol²·|b|², atol²)`` or at ``maxiter``.  Branchless: every
    iteration runs, and a stopped solve keeps its state (``where``), so the
    host reads nothing."""
    bs = torch.dot(b, b)
    atol2 = torch.clamp(tol * tol * bs, min=atol * atol)
    x = torch.zeros_like(b)
    r = b - hvp(x)
    p = r
    gamma = torch.dot(r, r)
    for _ in range(maxiter):
        active = gamma > atol2
        ap = hvp(p)
        alpha = gamma / torch.dot(p, ap)
        x_ = x + alpha * p
        r_ = r - alpha * ap
        gamma_ = torch.dot(r_, r_)
        p_ = r_ + (gamma_ / gamma) * p
        x = torch.where(active, x_, x)
        r = torch.where(active, r_, r)
        p = torch.where(active, p_, p)
        gamma = torch.where(active, gamma_, gamma)
    return x


def run_newton_cg(objective: Callable, x0: torch.Tensor, n_iter: int = 50,
                  cg_iters: int = 10,
                  bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> OptResult:
    """Truncated Newton: each iteration CG-solves ``H d = −g``
    (``cg_iters`` steps) on Hessian-vector products of a double backward,
    falls back to ``−g`` on a non-finite or ascent direction, and takes the
    largest of 8 halving steps that satisfies Armijo (all evaluated, the
    first passing one selected; none → the iterate stays).

    The objective must be twice differentiable under autograd: a custom
    ``autograd.Function`` whose backward is not differentiable raises.
    """
    dev, dt = x0.device, x0.dtype

    def project(x):
        return (torch.clamp(x, bounds[0], bounds[1]) if bounds is not None
                else x)

    ts = 0.5 ** torch.arange(8, dtype=dt, device=dev)
    x = project(x0.detach())
    best_x = x0.detach()
    best_loss = torch.full((), math.inf, dtype=dt, device=dev)
    best_it = torch.zeros((), dtype=torch.int32, device=dev)
    steps = torch.arange(n_iter, dtype=torch.int32, device=dev)
    history = torch.empty((n_iter,), dtype=dt, device=dev)
    for it in range(n_iter):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f0 = objective(xg)
            (g,) = torch.autograd.grad(f0, xg, create_graph=True)

            def hvp(v):
                if not g.requires_grad:  # a gradient constant in x
                    return torch.zeros_like(v)
                (hv,) = torch.autograd.grad(g, xg, grad_outputs=v,
                                            retain_graph=True,
                                            allow_unused=True)
                return torch.zeros_like(v) if hv is None else hv

            d = _cg(hvp, -g.detach(), cg_iters)
        f0, g = f0.detach(), g.detach()
        ok = torch.all(torch.isfinite(d)) & (torch.dot(d, g) < 0)
        d = torch.where(ok, d, -g)
        cand = project(x[None] + ts[:, None] * d[None])
        fc = _evaluate(objective, cand)
        armijo = fc <= f0 + 1e-4 * ts * torch.dot(g, d)
        first = torch.argmax(armijo.to(torch.int32))
        x_new = torch.where(torch.any(armijo), cand[first], x)
        better = f0 < best_loss
        best_x = torch.where(better, x, best_x)
        best_loss = torch.minimum(f0, best_loss)
        best_it = torch.where(better, steps[it], best_it)
        history[it] = f0
        x = x_new
    with torch.no_grad():
        final_loss = objective(x)
    use_final = final_loss < best_loss
    return OptResult(
        param=torch.where(use_final, x, best_x),
        loss=torch.minimum(final_loss, best_loss),
        best_iter=torch.where(use_final, steps[-1] if n_iter else best_it,
                              best_it),
        history=history, last_param=x)


def run_scipy_method(objective: Callable, x0: torch.Tensor, n_iter: int,
                     method: str, bounds=None) -> OptResult:
    """Route a scipy method name to its family's implementation."""
    if method in DERIVATIVE_FREE_METHODS:
        return run_nelder_mead(objective, x0, n_iter, bounds=bounds)
    if method in HESSIAN_METHODS:
        return run_newton_cg(objective, x0, n_iter, bounds=bounds)
    return run_lbfgs(objective, x0, n_iter, bounds=bounds)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def _grid_axis(lo: float, hi: float, n: int) -> np.ndarray:
    """``jnp.linspace(lo, hi, n)`` in float32 by its formula:
    ``lo·(1 − s) + hi·s`` with ``s = i / (n − 1)``, the last point ``hi``."""
    f32 = np.float32
    lo, hi = f32(lo), f32(hi)
    if n == 1:
        return np.array([lo], f32)
    s = np.arange(n - 1, dtype=f32) / f32(n - 1)
    return np.concatenate([lo * (f32(1) - s) + hi * s,
                           np.array([hi], f32)])


def run_sampler(objective: Callable, bounds, n_trials: int,
                sampler: str = "random",
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, Any]] = None,
                device=None) -> OptResult:
    """Black-box search over the box ``bounds = (lo, hi)``.

      * ``grid`` / ``uniform`` — the per-dimension linspace grid with
        ``round(n_trials^(1/d))`` points an axis (at least 2), the whole
        cartesian product;
      * ``random`` — ``n_trials`` uniform samples;
      * ``TPE`` — the two-stage stand-in of a batched program (half the
        budget uniform, half normal draws around the best decile, σ = 10 %
        of the box), with a warning; the sequential study is :mod:`.tpe`.

    The box and the samples are float32, whatever the objective's dtype.
    The random draws come from ``generator`` on ``device`` unless
    ``draws`` gives them: ``"uniform"`` (``[n1, d]`` samples in the box),
    and for ``TPE`` ``"pick"`` (``[n2]`` indices into the best decile) and
    ``"noise"`` (``[n2, d]`` standard normals).  The trials are evaluated
    one after another with no read to the host.
    """
    lo_np, hi_np = (np.asarray(b.detach().cpu() if torch.is_tensor(b) else b,
                               np.float64).reshape(-1).astype(np.float32)
                    for b in bounds)
    dev = torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))
    lo = torch.as_tensor(lo_np, device=dev)
    hi = torch.as_tensor(hi_np, device=dev)
    dim = lo_np.shape[0]
    draws = draws or {}

    def result(xs, losses):
        best = torch.argmin(losses)
        return OptResult(param=xs[best], loss=losses[best], best_iter=best,
                         history=losses, last_param=xs[best])

    if sampler in ("grid", "uniform"):
        per_dim = int(max(2, round(n_trials ** (1.0 / dim))))
        axes = [_grid_axis(lo_np[d], hi_np[d], per_dim) for d in range(dim)]
        mesh = np.meshgrid(*axes, indexing="ij")
        xs = torch.as_tensor(np.stack([m.reshape(-1) for m in mesh], -1),
                             device=dev)
        return result(xs, _evaluate(objective, xs))
    if sampler not in ("random", "TPE"):
        raise KeyError(f"Unknown sampler {sampler!r}")

    n1 = n_trials if sampler == "random" else max(n_trials // 2, 1)
    if "uniform" in draws:
        xs1 = torch.as_tensor(np.array(draws["uniform"], np.float32),
                              device=dev)
    else:
        u = torch.rand((n1, dim), generator=generator, dtype=torch.float32,
                       device=dev)
        xs1 = torch.maximum(lo, u * (hi - lo) + lo)
    losses1 = _evaluate(objective, xs1)
    if sampler == "random":
        return result(xs1, losses1)

    logger.warning(
        "sampler 'TPE' inside a batched solve uses the two-stage "
        "random-search approximation, not sequential TPE semantics.")
    n2 = n_trials - n1
    n_top = max(n1 // 10, 1)
    top = torch.argsort(losses1, stable=True)[:n_top]
    if "pick" in draws:
        pick = torch.as_tensor(np.array(draws["pick"], np.int64),
                               device=dev)
        noise = torch.as_tensor(np.array(draws["noise"], np.float32),
                                device=dev)
    else:
        pick = torch.randint(0, n_top, (n2,), generator=generator,
                             device=dev)
        noise = torch.randn((n2, dim), generator=generator,
                            dtype=torch.float32, device=dev)
    centers = xs1[top[pick]]
    spread = (hi - lo) * 0.1
    xs2 = torch.clamp(centers + noise * spread, lo, hi)
    losses2 = _evaluate(objective, xs2)
    return result(torch.cat([xs1, xs2]), torch.cat([losses1, losses2]))
