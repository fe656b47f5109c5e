"""On-device optimization loops.

PyTorch counterpart of the JAX package's ``optim.py`` (``lax.scan`` loops
over optax there):

  * :func:`run_first_order` (:class:`FirstOrderLoop`) — the torch-optimizer
    names of the reference, each written out as optax 0.2.6 computes it,
    with optax's staircase ``exponential_decay`` schedule and best-iterate
    tracking.  An objective that returns a vector of losses is a batch of
    independent problems (one per leading row of ``x``): the gradient of
    their sum is each row's own gradient, and the best iterate is tracked
    per row.
  * :func:`run_scipy_method` — the scipy names, per family
    (:func:`scipy_loop`): quasi-Newton → :func:`run_lbfgs`
    (:class:`LbfgsLoop`, optax's L-BFGS with its zoom line search),
    derivative-free → :func:`run_nelder_mead` (:class:`NelderMeadLoop`, a
    branchless simplex), Hessian/HVP → :func:`run_newton_cg`
    (:class:`NewtonCgLoop`, CG on Hessian-vector products of a double
    backward).
  * :func:`run_sampler` (:class:`SamplerProgram`) — the random and grid
    samplers over a box, and the two-stage stand-in the JAX package runs
    for ``TPE`` inside a batched program (the sequential TPE study is
    :mod:`.tpe`).

Every loop is a step function over state held in device tensors, with
**no host synchronisation**: on the card it is captured once as a CUDA
graph and replayed (:mod:`.graphs`, the counterpart of the JAX package's
jitted ``lax.scan``), on the CPU it runs in a Python loop.  The per-step
scalars of the first-order methods depend only on the step index: they are
tabulated once per loop on the device and read by the step from its
counter.  The zoom line search's loop depends on the data: on the card it
is the conditional WHILE node of a :class:`~.graphs.WhileGraph` (the
counterpart of ``lax.while_loop``), which reads its stop flag on the
device; on the CPU each trial reads the flag (``OptResult.host_reads``
counts those reads).  The samplers' trials and argmin are one
:class:`~.graphs.CapturedProgram` of the random draws.
"""

from __future__ import annotations

import logging
import math
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import graphs
from .device import resolve_device

__all__ = ["OptResult", "Adam", "AdamW", "NAdam", "Adamax", "RAdam",
           "Adagrad", "Adadelta", "RMSprop", "SGD", "make_optimizer",
           "FirstOrderLoop", "run_first_order", "LbfgsLoop", "run_lbfgs",
           "NelderMeadLoop", "run_nelder_mead", "NewtonCgLoop",
           "run_newton_cg", "scipy_loop", "run_scipy_method",
           "SamplerProgram", "run_sampler", "FIRST_ORDER_METHODS",
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


class _GraphLoop:
    """A loop that keeps the graph of its first run on the card in
    :attr:`graph` (None before it, and on the CPU)."""

    def release(self) -> None:
        """Drop the graph and its memory pool now (a loop used once): a
        loop and its graph refer to each other, so the collector would
        free them only at its next run."""
        self.graph = None


class FirstOrderLoop(_GraphLoop):
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
        _check_iterate(c.x, x0)
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
    return _run_once(FirstOrderLoop(objective, n_iter, method, lr, lr_decay,
                                    lr_step, track_best, has_aux, bounds,
                                    record_every), x0)


# ---------------------------------------------------------------------------
# L-BFGS with optax's zoom line search
# ---------------------------------------------------------------------------

def _value_and_grad(objective, x):
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = objective(xg)
        (grad,) = torch.autograd.grad(loss, xg)
    return loss.detach(), grad


def _flat_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _lbfgs_direction(grad, x, c, memory_size: int):
    """optax ``scale_by_lbfgs`` (scaled initial preconditioner): update the
    memory with the last step's differences, return ``P_k · grad``.

    ``c`` holds the device state: the memory ``dp``, ``du``, ``rho``, the
    last iterate and gradient ``params``, ``updates``, the ring ``ring``
    (``arange(memory_size)``) and the iteration counter ``count``; the
    memory and the last iterate are updated in place (the counter is the
    caller's).  The first iteration (``count = 0``) is selected on the
    device: it leaves the differences as they are and scales by a capped
    reciprocal of the gradient norm."""
    count = c.count
    memory_idx = count % memory_size
    prev_idx = (count - 1) % memory_size
    started = (count > 0)[0]
    diff_p = x - c.params
    diff_u = grad - c.updates
    vdot = _flat_dot(diff_u, diff_p)
    weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
    c.dp.index_copy_(0, prev_idx, torch.where(
        started, diff_p, c.dp.index_select(0, prev_idx)[0])[None])
    c.du.index_copy_(0, prev_idx, torch.where(
        started, diff_u, c.du.index_select(0, prev_idx)[0])[None])
    c.rho.index_copy_(0, prev_idx, torch.where(started, weight, 0.0)[None])
    num = _flat_dot(diff_u, diff_p)
    den = torch.sum(diff_u * diff_u)
    scale = torch.where(
        started, torch.where(den > 0.0, num / den, 1.0),
        torch.clamp(1.0 / torch.sqrt(torch.sum(grad * grad)), max=1.0))
    ring = (memory_idx + c.ring) % memory_size
    slots = [ring[j:j + 1] for j in range(memory_size)]
    vec = grad
    alphas = [None] * memory_size
    for j in reversed(range(memory_size)):
        rho = c.rho.index_select(0, slots[j])[0]
        alpha = rho * _flat_dot(c.dp.index_select(0, slots[j])[0], vec)
        vec = vec - alpha * c.du.index_select(0, slots[j])[0]
        alphas[j] = alpha
    vec = scale * vec
    for j in range(memory_size):
        rho = c.rho.index_select(0, slots[j])[0]
        beta = rho * _flat_dot(c.du.index_select(0, slots[j])[0], vec)
        vec = vec + (alphas[j] - beta) * c.dp.index_select(0, slots[j])[0]
    c.params.copy_(x)
    c.updates.copy_(grad)
    return vec


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
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    ``fpa`` at ``a``."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


#: the zoom line search's scalars, in the order of :class:`LbfgsLoop`'s
#: state vector (``interval_found`` is 0 or 1)
_LS_FIELDS = ("count", "stepsize", "value", "slope", "interval_found", "low",
              "value_low", "slope_low", "high", "value_high", "slope_high",
              "cubic_ref", "value_cubic_ref", "safe_stepsize", "safe_value",
              "value_init", "slope_init")
_COUNT, _STEPSIZE = _LS_FIELDS.index("count"), _LS_FIELDS.index("stepsize")


def _pick(cond, new, old):
    """``where(cond, new, old)`` over parallel tuples of scalars."""
    return tuple(torch.where(cond, a, b) for a, b in zip(new, old))


class LbfgsLoop(_GraphLoop):
    """optax ``lbfgs(memory_size=10)`` with its zoom line search (at most
    ``max_steps`` trials an iteration, first guess 1) and
    best-iterate tracking, as a loop over device state, reusable for
    further solves of the same shapes.

    An iteration has three parts, each a function of the state alone:

      * :meth:`_pre` — the value and gradient at ``x``, the direction
        (:func:`_lbfgs_direction`), its slope, the history and the best
        iterate, and the line search's start;
      * :meth:`_trial` — one trial of optax's ``zoom_linesearch``: the
        interval search or the zoom (cubic, quadratic or bisection step),
        chosen on the device, the evaluation at the trial step, the
        bookkeeping of the bracket and of the safe step, and the flag
        ``done or failed``; a failed search steps by the safe step when
        there is one or when the decrease error is infinite;
      * :meth:`_post` — the step, the projection onto ``bounds`` and the
        trial count.

    The line search's scalars are in the iterate's dtype, as optax keeps
    them.  On the card the three parts are a
    :class:`~event_based_bos_tpu_torch.graphs.WhileGraph` (the trials a
    conditional WHILE node of one CUDA graph, one launch an iteration, no
    read to the host); on the CPU and inside
    :func:`~event_based_bos_tpu_torch.graphs.eager_loops` the same trial
    runs in a Python loop that reads the flag after each trial (one host
    read a trial).  :meth:`run` returns copies of the outputs.
    """

    #: optax's ``zoom_linesearch`` as ``lbfgs`` sets it (``tol = 0``, no
    #: maximal step size)
    max_steps, increase_factor, interval_threshold = 20, 2.0, 1e-5
    slope_rtol, curv_rtol, approx_dec_rtol = 1e-4, 0.9, 1e-6

    def __init__(self, objective: Callable, n_iter: int,
                 memory_size: int = 10,
                 bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        self.objective = objective
        self.n_iter = n_iter
        self.memory_size = memory_size
        self.bounds = bounds
        self.graph: Optional[graphs.WhileGraph] = None
        self._c: Optional[SimpleNamespace] = None

    # -- the parts -----------------------------------------------------------
    def _pre(self) -> None:
        c = self._c
        loss, grad = _value_and_grad(self.objective, c.x)
        loss = loss.to(c.x.dtype)
        direction = -_lbfgs_direction(grad, c.x, c, self.memory_size)
        slope = _flat_dot(direction, grad)
        c.history.index_copy_(0, c.count, loss[None])
        better = loss < c.best_loss
        c.best_x.copy_(torch.where(better, c.x, c.best_x))
        c.best_it.copy_(torch.where(better, c.count.to(torch.int32)[0],
                                    c.best_it))
        c.best_loss.copy_(torch.minimum(loss, c.best_loss))
        c.direction.copy_(direction)
        zero = torch.zeros_like(loss)
        start = dict(count=zero, stepsize=zero, value=loss, slope=slope,
                     interval_found=zero, low=zero, value_low=loss,
                     slope_low=slope, high=zero, value_high=loss,
                     slope_high=slope, cubic_ref=zero, value_cubic_ref=loss,
                     safe_stepsize=zero, safe_value=loss, value_init=loss,
                     slope_init=slope)
        c.ls.copy_(torch.stack([start[k] for k in _LS_FIELDS]))

    def _trial(self) -> None:
        c = self._c
        slope_rtol, curv_rtol = self.slope_rtol, self.curv_rtol
        s = dict(zip(_LS_FIELDS, c.ls.unbind()))
        count, found = s["count"], s["interval_found"] != 0
        value_init, slope_init = s["value_init"], s["slope_init"]
        prev = (s["stepsize"], s["value"], s["slope"])
        low = (s["low"], s["value_low"], s["slope_low"])
        high = (s["high"], s["value_high"], s["slope_high"])
        # the interval search's guess: 1, then twice the last step
        guess = torch.where(count == 0, 1.0, self.increase_factor * prev[0])
        # the zoom's: the cubic's or the quadratic's minimum well inside
        # the bracket, else its middle
        delta = torch.abs(high[0] - low[0])
        left = torch.minimum(high[0], low[0])
        right = torch.maximum(high[0], low[0])
        cubic = _cubicmin(*low, *high[:2], s["cubic_ref"],
                          s["value_cubic_ref"])
        use_cubic = ((cubic > left + 0.2 * delta)
                     & (cubic < right - 0.2 * delta))
        quad = _quadmin(*low, *high[:2])
        use_quad = (~use_cubic & (quad > left + 0.1 * delta)
                    & (quad < right - 0.1 * delta))
        middle = torch.where(use_cubic, cubic, torch.where(
            use_quad, quad, (low[0] + high[0]) / 2.0))
        new = torch.where(found, middle, guess)

        v, g = _value_and_grad(self.objective, c.x + new * c.direction)
        v = v.to(c.x.dtype)
        sl = _flat_dot(g, c.direction)
        trial = (new, v, sl)
        dec = v - value_init - slope_rtol * new * slope_init
        approx = torch.maximum(
            sl - (2 * slope_rtol - 1.0) * slope_init,
            v - value_init - self.approx_dec_rtol * torch.abs(value_init))
        zero = torch.zeros_like(v)
        dec = torch.maximum(torch.minimum(approx, dec), zero)
        dec = torch.where(torch.isnan(dec), math.inf, dec)
        curv = torch.maximum(
            torch.abs(sl) - curv_rtol * torch.abs(slope_init), zero)
        curv = torch.where(torch.isnan(curv), math.inf, curv)
        done = torch.maximum(dec, curv) <= 0.0
        last = count + 1 >= self.max_steps
        # the safe step: sufficient decrease (and, zooming, a lower value)
        take_safe = (dec <= 0.0) & (~found | (v < s["safe_value"]))
        safe, safe_value = _pick(take_safe, (new, v),
                                 (s["safe_stepsize"], s["safe_value"]))

        # the interval search's bracket
        set_high = (dec > 0.0) | ((v >= prev[1]) & (count > 0))
        set_low = (sl >= 0.0) & ~set_high
        s_low = _pick(set_low, trial, prev)
        s_high = _pick(set_low, prev, trial)
        s_found = set_high | set_low | done
        s_failed = last & ~done
        # the zoom's bracket
        high_mid = (dec > 0.0) | (v >= low[1])
        high_low = (sl * (high[0] - low[0]) >= 0.0) & ~high_mid
        z_high = _pick(high_low, low, _pick(high_mid, trial, high))
        z_low = _pick(high_mid, low, trial)
        z_ref = _pick(high_mid | high_low, high[:2], low[:2])
        z_failed = (last | ((delta <= self.interval_threshold)
                             & (safe > 0.0))) & ~done

        new_low = _pick(found, z_low, s_low)
        new_high = _pick(found, z_high, s_high)
        ref = _pick(found, z_ref, s_low[:2])
        failed = torch.where(found, z_failed, s_failed)
        # a failed search: the safe step when there is one (or when no step
        # has a finite decrease error)
        stepsize = torch.where(failed & ((safe > 0.0) | torch.isinf(dec)),
                               safe, new)
        out = dict(count=count + 1, stepsize=stepsize, value=v, slope=sl,
                   interval_found=(found | s_found).to(v.dtype),
                   low=new_low[0], value_low=new_low[1],
                   slope_low=new_low[2], high=new_high[0],
                   value_high=new_high[1], slope_high=new_high[2],
                   cubic_ref=ref[0], value_cubic_ref=ref[1],
                   safe_stepsize=safe, safe_value=safe_value,
                   value_init=value_init, slope_init=slope_init)
        c.ls.copy_(torch.stack([out[k] for k in _LS_FIELDS]))
        c.flag.copy_(done | failed)

    def _post(self) -> None:
        c = self._c
        x = c.x + c.ls[_STEPSIZE] * c.direction
        if self.bounds is not None:
            x = torch.clamp(x, self.bounds[0], self.bounds[1])
        c.ls_trials.index_copy_(0, c.count,
                                c.ls[_COUNT:_COUNT + 1].to(torch.int32))
        c.x.copy_(x)
        c.count.add_(1)

    def _iterate_eagerly(self) -> int:
        """One iteration with the trials in a Python loop; returns the
        trials (each one read of the flag)."""
        self._pre()
        trials = 0
        while True:
            self._trial()
            trials += 1
            if bool(self._c.flag):
                break
        self._post()
        return trials

    def _warm_up(self) -> None:
        """Each part once, then the state as it was: the libraries' lazy
        state is built outside the capture, and the solve is unchanged."""
        saved = {k: v.clone() for k, v in vars(self._c).items()}
        self._pre()
        self._trial()
        self._post()
        for k, v in saved.items():
            getattr(self._c, k).copy_(v)

    # -- state ---------------------------------------------------------------
    def _allocate(self, x0: torch.Tensor) -> None:
        x = x0.detach().clone()
        dev, dt, n, m = x.device, x.dtype, self.n_iter, self.memory_size
        memory = torch.zeros((m,) + tuple(x.shape), dtype=dt, device=dev)
        self._c = SimpleNamespace(
            x=x, direction=torch.zeros_like(x), dp=memory,
            du=torch.zeros_like(memory),
            rho=torch.zeros((m,), dtype=dt, device=dev),
            params=torch.zeros_like(x), updates=torch.zeros_like(x),
            ring=torch.arange(m, device=dev), best_x=x.clone(),
            best_loss=torch.full((), math.inf, dtype=dt, device=dev),
            best_it=torch.zeros((), dtype=torch.int32, device=dev),
            history=torch.zeros((n,), dtype=dt, device=dev),
            ls_trials=torch.zeros((n,), dtype=torch.int32, device=dev),
            ls=torch.zeros((len(_LS_FIELDS),), dtype=dt, device=dev),
            flag=torch.zeros((), dtype=torch.bool, device=dev),
            count=torch.zeros((1,), dtype=torch.int64, device=dev))

    def _reset(self, x0: torch.Tensor) -> None:
        c = self._c
        _check_iterate(c.x, x0)
        c.x.copy_(x0)
        c.best_x.copy_(x0)
        for t in (c.dp, c.du, c.rho, c.params, c.updates, c.best_it,
                  c.count):
            t.zero_()
        c.best_loss.fill_(math.inf)

    # -- the solve -----------------------------------------------------------
    def run(self, x0: torch.Tensor) -> OptResult:
        """``n_iter`` iterations from ``x0``; returns copies of the outputs
        (see :func:`run_lbfgs`)."""
        if self._c is None:
            self._allocate(x0)
        else:
            self._reset(x0.detach())
        dev = self._c.x.device
        reads = 0
        if self.n_iter > 0 and graphs.graph_route(dev):
            if self.graph is None:
                self.graph = graphs.WhileGraph(
                    self._pre, self._trial, self._post, self._c.flag, dev,
                    warmup=self._warm_up)
            self.graph.run(self.n_iter)
        else:
            for _ in range(self.n_iter):
                reads += self._iterate_eagerly()
        return self._result(reads)

    def _result(self, reads: int) -> OptResult:
        c = self._c
        with torch.no_grad():
            final = self.objective(c.x).to(c.x.dtype)
        use_final = final < c.best_loss
        return OptResult(
            param=torch.where(use_final, c.x, c.best_x),
            loss=torch.minimum(final, c.best_loss),
            best_iter=torch.where(use_final, self.n_iter - 1, c.best_it),
            history=c.history.clone(), last_param=c.x.clone(),
            host_reads=reads, ls_trials=c.ls_trials.clone())


def _check_iterate(x: torch.Tensor, x0: torch.Tensor) -> None:
    if x0.shape != x.shape or x0.dtype != x.dtype or x0.device != x.device:
        raise ValueError(
            f"this loop solves for a {tuple(x.shape)} {x.dtype} iterate on "
            f"{x.device}, got {tuple(x0.shape)} {x0.dtype} on {x0.device}")


def _run_once(loop, x0: torch.Tensor) -> OptResult:
    """``loop.run(x0)``, its graph (and memory pool) released after."""
    try:
        return loop.run(x0)
    finally:
        loop.release()


def run_lbfgs(objective: Callable, x0: torch.Tensor, n_iter: int = 100,
              memory_size: int = 10,
              bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> OptResult:
    """optax ``lbfgs(memory_size=10)`` with its zoom line search (at most 20
    evaluations a step, first guess 1) and best-iterate tracking: one
    :class:`LbfgsLoop`, run once.

    ``bounds = (lo, hi)`` projects every iterate onto the box.  The result
    holds ``ls_trials``, the line search's trials of each iteration
    (``[n_iter]`` int32, counted on the device), and ``host_reads``, the
    reads of the route: 0 on the card, one a trial on the CPU and inside
    :func:`~event_based_bos_tpu_torch.graphs.eager_loops`.
    """
    return _run_once(LbfgsLoop(objective, n_iter, memory_size, bounds), x0)


# ---------------------------------------------------------------------------
# Nelder-Mead and Newton-CG
# ---------------------------------------------------------------------------

def _evaluate(objective, xs: torch.Tensor) -> torch.Tensor:
    """``objective`` at each row of ``xs`` (no gradient), stacked."""
    with torch.no_grad():
        return torch.stack([objective(x) for x in xs])


def _row(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[index]`` for a 0-d index tensor, with no read to the host."""
    return t.index_select(0, index.reshape(1))[0]


def _projector(bounds):
    if bounds is None:
        return lambda x: x
    return lambda x: torch.clamp(x, bounds[0], bounds[1])


class NelderMeadLoop(_GraphLoop):
    """Derivative-free Nelder-Mead simplex, branchless, as a loop over
    device state (the simplex, its values, the history and a step
    counter), reusable for further solves of the same shapes.

    Standard coefficients (ρ=1, χ=2, ψ=0.5, σ=0.5) and scipy's initial
    simplex (x0 ± 5 % per coordinate, 0.00025 for zero coordinates; with
    ``bounds``, toward whichever side of the box moves).  Every step
    (:meth:`_step`) evaluates reflection, expansion, both contractions and
    the shrunk simplex and selects with ``where``; the simplex is ordered
    with a stable sort, so ties keep their order.  The initial simplex is
    evaluated at :meth:`run`; the steps run as a
    :class:`~event_based_bos_tpu_torch.graphs.StepGraph` on the card (op by
    op inside :func:`~event_based_bos_tpu_torch.graphs.eager_loops`), in a
    Python loop on the CPU.
    """

    def __init__(self, objective: Callable, n_iter: int,
                 bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        self.objective = objective
        self.n_iter = n_iter
        self.project = _projector(bounds)
        self.bounds = bounds
        self.graph: Optional[graphs.StepGraph] = None
        self._c: Optional[SimpleNamespace] = None

    def _simplex(self, x0: torch.Tensor) -> torch.Tensor:
        d = x0.shape[0]
        x0 = self.project(x0.detach())
        pert = torch.where(x0 != 0, x0 * 0.05, 0.00025)
        if self.bounds is not None:
            up = self.project(x0 + pert)
            down = self.project(x0 - pert)
            diag_vals = torch.where(torch.abs(up - x0) > 0, up, down)
        else:
            diag_vals = x0 + pert
        vertices = x0.repeat(d, 1)
        idx = torch.arange(d, device=x0.device)
        vertices[idx, idx] = diag_vals
        return torch.cat([x0[None], vertices], dim=0)

    def _step(self, rho: float = 1.0, chi: float = 2.0, psi: float = 0.5,
              sigma: float = 0.5) -> None:
        c = self._c
        d = c.simplex.shape[1]
        project = self.project
        order = torch.argsort(c.fvals, stable=True)
        simplex = c.simplex.index_select(0, order)
        fvals = c.fvals.index_select(0, order)
        xbar = torch.mean(simplex[:d], dim=0)
        worst = simplex[d]
        xr = project(xbar + rho * (xbar - worst))
        xe = project(xbar + rho * chi * (xbar - worst))
        xoc = project(xbar + psi * rho * (xbar - worst))
        xic = project(xbar - psi * (xbar - worst))
        fr, fe, foc, fic = _evaluate(self.objective,
                                     torch.stack([xr, xe, xoc, xic]))

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
        fshrunk = _evaluate(self.objective, shrunk)
        fvals = torch.where(shrink, fshrunk, freplaced)
        c.simplex.copy_(torch.where(shrink, shrunk, replaced))
        c.fvals.copy_(fvals)
        c.history.index_copy_(0, c.count, torch.min(fvals)[None])
        c.count.add_(1)

    def run(self, x0: torch.Tensor) -> OptResult:
        """``n_iter`` steps from ``x0``; returns copies of the outputs (see
        :func:`run_nelder_mead`)."""
        simplex = self._simplex(x0)
        fvals = _evaluate(self.objective, simplex)
        if self._c is None:
            self._c = SimpleNamespace(
                simplex=simplex, fvals=fvals,
                history=torch.zeros((self.n_iter,), dtype=fvals.dtype,
                                    device=fvals.device),
                count=torch.zeros((1,), dtype=torch.int64,
                                  device=fvals.device))
        else:
            c = self._c
            _check_iterate(c.simplex, simplex)
            c.simplex.copy_(simplex)
            c.fvals.copy_(fvals)
            c.count.zero_()
        c = self._c
        if graphs.graph_route(c.simplex.device):
            if self.graph is None:
                self.graph = graphs.StepGraph(self._step, c.simplex.device)
            self.graph.run(self.n_iter)
        else:
            for _ in range(self.n_iter):
                self._step()
        best = torch.argmin(c.fvals)
        param = _row(c.simplex, best)
        return OptResult(param=param, loss=_row(c.fvals, best),
                         best_iter=torch.full((), self.n_iter - 1,
                                              dtype=torch.int32,
                                              device=param.device),
                         history=c.history.clone(), last_param=param)


def run_nelder_mead(objective: Callable, x0: torch.Tensor, n_iter: int = 100,
                    bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> OptResult:
    """Derivative-free Nelder-Mead simplex on the device: one
    :class:`NelderMeadLoop`, run once."""
    return _run_once(NelderMeadLoop(objective, n_iter, bounds), x0)


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


class NewtonCgLoop(_GraphLoop):
    """Truncated Newton as a loop over device state (the iterate, the best
    iterate, loss and step, the history and a step counter), reusable for
    further solves of the same shapes.

    Each step (:meth:`_step`) CG-solves ``H d = −g`` (``cg_iters`` steps)
    on Hessian-vector products of a double backward, falls back to ``−g``
    on a non-finite or ascent direction, and takes the largest of 8
    halving steps that satisfies Armijo (all evaluated, the first passing
    one selected; none → the iterate stays).  Whether the gradient depends
    on ``x`` at all (else every Hessian-vector product is 0) is decided at
    the loop's first step.  The steps run as a
    :class:`~event_based_bos_tpu_torch.graphs.StepGraph` on the card (the
    double backward captured inside the step), in a Python loop on the
    CPU.

    The objective must be twice differentiable under autograd: a custom
    ``autograd.Function`` whose backward is not differentiable raises.
    """

    def __init__(self, objective: Callable, n_iter: int, cg_iters: int = 10,
                 bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        self.objective = objective
        self.n_iter = n_iter
        self.cg_iters = cg_iters
        self.project = _projector(bounds)
        self.graph: Optional[graphs.StepGraph] = None
        self._c: Optional[SimpleNamespace] = None
        self._curved: Optional[bool] = None

    def _step(self) -> None:
        c = self._c
        xg = c.x.detach().requires_grad_(True)
        with torch.enable_grad():
            f0 = self.objective(xg)
            (g,) = torch.autograd.grad(f0, xg, create_graph=True)
            if self._curved is None:
                self._curved = g.requires_grad

            def hvp(v):
                if not self._curved:  # a gradient constant in x
                    return torch.zeros_like(v)
                (hv,) = torch.autograd.grad(g, xg, grad_outputs=v,
                                            retain_graph=True,
                                            allow_unused=True)
                return torch.zeros_like(v) if hv is None else hv

            d = _cg(hvp, -g.detach(), self.cg_iters)
        f0, g = f0.detach(), g.detach()
        ok = torch.all(torch.isfinite(d)) & (torch.dot(d, g) < 0)
        d = torch.where(ok, d, -g)
        cand = self.project(c.x[None] + c.ts[:, None] * d[None])
        fc = _evaluate(self.objective, cand)
        armijo = fc <= f0 + 1e-4 * c.ts * torch.dot(g, d)
        first = torch.argmax(armijo.to(torch.int32))
        x_new = torch.where(torch.any(armijo), _row(cand, first), c.x)
        better = f0 < c.best_loss
        c.best_x.copy_(torch.where(better, c.x, c.best_x))
        c.best_loss.copy_(torch.minimum(f0, c.best_loss))
        c.best_it.copy_(torch.where(better, c.count.to(torch.int32)[0],
                                    c.best_it))
        c.history.index_copy_(0, c.count, f0[None])
        c.x.copy_(x_new)
        c.count.add_(1)

    def _start(self, x0: torch.Tensor) -> None:
        x0 = x0.detach()
        if self._c is None:
            dev, dt = x0.device, x0.dtype
            self._c = SimpleNamespace(
                x=self.project(x0).clone(), best_x=x0.clone(),
                best_loss=torch.full((), math.inf, dtype=dt, device=dev),
                best_it=torch.zeros((), dtype=torch.int32, device=dev),
                history=torch.zeros((self.n_iter,), dtype=dt, device=dev),
                ts=0.5 ** torch.arange(8, dtype=dt, device=dev),
                count=torch.zeros((1,), dtype=torch.int64, device=dev))
            return
        c = self._c
        _check_iterate(c.x, x0)
        c.x.copy_(self.project(x0))
        c.best_x.copy_(x0)
        c.best_loss.fill_(math.inf)
        c.best_it.zero_()
        c.count.zero_()

    def run(self, x0: torch.Tensor) -> OptResult:
        """``n_iter`` steps from ``x0``; returns copies of the outputs (see
        :func:`run_newton_cg`)."""
        self._start(x0)
        c = self._c
        if graphs.graph_route(c.x.device):
            if self.graph is None:
                self.graph = graphs.StepGraph(self._step, c.x.device)
            self.graph.run(self.n_iter)
        else:
            for _ in range(self.n_iter):
                self._step()
        with torch.no_grad():
            final_loss = self.objective(c.x)
        use_final = final_loss < c.best_loss
        best_iter = (torch.where(use_final, self.n_iter - 1, c.best_it)
                     if self.n_iter > 0 else c.best_it.clone())
        return OptResult(
            param=torch.where(use_final, c.x, c.best_x),
            loss=torch.minimum(final_loss, c.best_loss), best_iter=best_iter,
            history=c.history.clone(), last_param=c.x.clone())


def run_newton_cg(objective: Callable, x0: torch.Tensor, n_iter: int = 50,
                  cg_iters: int = 10,
                  bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> OptResult:
    """Truncated Newton on Hessian-vector products of a double backward:
    one :class:`NewtonCgLoop`, run once."""
    return _run_once(NewtonCgLoop(objective, n_iter, cg_iters, bounds), x0)


def scipy_loop(objective: Callable, n_iter: int, method: str, bounds=None):
    """The loop of a scipy method's family, reusable from frame to frame:
    Nelder-Mead for the derivative-free methods, Newton-CG for those that
    take a Hessian, L-BFGS for the rest."""
    if method in DERIVATIVE_FREE_METHODS:
        return NelderMeadLoop(objective, n_iter, bounds=bounds)
    if method in HESSIAN_METHODS:
        return NewtonCgLoop(objective, n_iter, bounds=bounds)
    return LbfgsLoop(objective, n_iter, bounds=bounds)


def run_scipy_method(objective: Callable, x0: torch.Tensor, n_iter: int,
                     method: str, bounds=None) -> OptResult:
    """Route a scipy method name to its family's loop, run once."""
    return _run_once(scipy_loop(objective, n_iter, method, bounds), x0)


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


class SamplerProgram:
    """Black-box search over the box ``bounds = (lo, hi)`` for one
    objective, trial count and sampler, reusable from frame to frame.

      * ``grid`` / ``uniform`` — the per-dimension linspace grid with
        ``round(n_trials^(1/d))`` points an axis (at least 2), the whole
        cartesian product (made once, on the device);
      * ``random`` — ``n_trials`` uniform samples;
      * ``TPE`` — the two-stage stand-in of a batched program (half the
        budget uniform, half normal draws around the best decile, σ = 10 %
        of the box), with a warning; the sequential study is :mod:`.tpe`.

    The box and the samples are float32, whatever the objective's dtype,
    on ``device`` (the card when None; without one it raises).
    :meth:`run` draws the random numbers (outside any capture, from the
    generator in the order the samplers always drew them, or from
    ``draws``), then evaluates every trial, one after another, and takes
    the argmin in one function of the draws with no read to the host: with
    ``kept`` a :class:`~event_based_bos_tpu_torch.graphs.CapturedProgram`
    (captured at its first run on the card, replayed after), else op by op
    (a program used once).
    """

    def __init__(self, objective: Callable, bounds, n_trials: int,
                 sampler: str = "random", device=None, kept: bool = True):
        lo_np, hi_np = (np.asarray(b.detach().cpu() if torch.is_tensor(b)
                                   else b, np.float64).reshape(-1)
                        .astype(np.float32) for b in bounds)
        self.device = resolve_device(device)
        self.objective = objective
        self.n_trials = n_trials
        self.sampler = sampler
        self.lo = torch.as_tensor(lo_np, device=self.device)
        self.hi = torch.as_tensor(hi_np, device=self.device)
        self.dim = lo_np.shape[0]
        self.grid = None
        if sampler in ("grid", "uniform"):
            per_dim = int(max(2, round(n_trials ** (1.0 / self.dim))))
            axes = [_grid_axis(lo_np[d], hi_np[d], per_dim)
                    for d in range(self.dim)]
            mesh = np.meshgrid(*axes, indexing="ij")
            self.grid = torch.as_tensor(
                np.stack([m.reshape(-1) for m in mesh], -1),
                device=self.device)
        elif sampler not in ("random", "TPE"):
            raise KeyError(f"Unknown sampler {sampler!r}")
        self.n1 = n_trials if sampler == "random" else max(n_trials // 2, 1)
        self.program = graphs.CapturedProgram(self._trials) if kept else None

    @property
    def graph(self):
        """The captured call (None before the first run on the card, and
        on the per-call route)."""
        calls = list(self.program.kept.values()) if self.program else []
        return calls[0] if calls else None

    def release(self) -> None:
        """Drop the captured call and its memory pool now."""
        if self.program is not None:
            self.program.kept.clear()

    def _best(self, xs, losses):
        best = torch.argmin(losses)
        return _row(xs, best), _row(losses, best), best, losses

    def _trials(self, xs1, pick=None, noise=None):
        losses1 = _evaluate(self.objective, xs1)
        if pick is None:
            return self._best(xs1, losses1)
        n_top = max(self.n1 // 10, 1)
        top = torch.argsort(losses1, stable=True)[:n_top]
        centers = xs1.index_select(0, top.index_select(0, pick))
        spread = (self.hi - self.lo) * 0.1
        xs2 = torch.clamp(centers + noise * spread, self.lo, self.hi)
        losses2 = _evaluate(self.objective, xs2)
        return self._best(torch.cat([xs1, xs2]),
                          torch.cat([losses1, losses2]))

    def _draws(self, generator, draws) -> Tuple[torch.Tensor, ...]:
        if self.grid is not None:
            return (self.grid,)
        dev, draws = self.device, draws or {}
        if "uniform" in draws:
            xs1 = torch.as_tensor(np.array(draws["uniform"], np.float32),
                                  device=dev)
        else:
            u = torch.rand((self.n1, self.dim), generator=generator,
                           dtype=torch.float32, device=dev)
            xs1 = torch.maximum(self.lo, u * (self.hi - self.lo) + self.lo)
        if self.sampler == "random":
            return (xs1,)
        logger.warning(
            "sampler 'TPE' inside a batched solve uses the two-stage "
            "random-search approximation, not sequential TPE semantics.")
        n2 = self.n_trials - self.n1
        n_top = max(self.n1 // 10, 1)
        if "pick" in draws:
            pick = torch.as_tensor(np.array(draws["pick"], np.int64),
                                   device=dev)
            noise = torch.as_tensor(np.array(draws["noise"], np.float32),
                                    device=dev)
        else:
            pick = torch.randint(0, n_top, (n2,), generator=generator,
                                 device=dev)
            noise = torch.randn((n2, self.dim), generator=generator,
                                dtype=torch.float32, device=dev)
        return xs1, pick, noise

    def run(self, generator: Optional[torch.Generator] = None,
            draws: Optional[Dict[str, Any]] = None) -> OptResult:
        """The trials of one solve; ``draws`` (``"uniform"``: ``[n1, d]``
        samples in the box; for ``TPE`` also ``"pick"``, ``[n2]`` indices
        into the best decile, and ``"noise"``, ``[n2, d]`` standard
        normals) replaces the generator's."""
        args = self._draws(generator, draws)
        evaluate = self.program if self.program is not None else self._trials
        param, loss, best, losses = evaluate(*args)
        return OptResult(param=param, loss=loss, best_iter=best,
                         history=losses, last_param=param)


def run_sampler(objective: Callable, bounds, n_trials: int,
                sampler: str = "random",
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, Any]] = None,
                device=None) -> OptResult:
    """Black-box search over the box ``bounds = (lo, hi)`` (see
    :class:`SamplerProgram`): one program used once, op by op.  The random
    draws come from ``generator`` on ``device`` (by default the
    generator's) unless ``draws`` gives them."""
    dev = torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))
    return SamplerProgram(objective, bounds, n_trials, sampler, dev,
                          kept=False).run(generator, draws)
