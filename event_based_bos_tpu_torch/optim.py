"""On-device first-order optimization loop.

PyTorch counterpart of the JAX package's ``optim.py::run_first_order``
(a ``lax.scan`` over optax steps there).  The loop here is a Python loop
of device work with **no host synchronisation per step**: the loss
history, the best loss, its step and the best iterate stay in device
tensors, updated with ``where``/``minimum``, and nothing is read back
until the caller asks.

Adam is written out as optax computes it — moments ``(1−b)·g + b·m``,
bias correction at ``count + 1``, ``eps`` outside the square root — with
the learning rate of optax's staircase ``exponential_decay`` schedule
(``lr · decay^floor(count / lr_step)``).  The per-step scalars depend only
on the step index, so they are Python numbers and cost no device traffic.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["OptResult", "Adam", "make_optimizer", "run_first_order",
           "FIRST_ORDER_METHODS", "SCIPY_METHODS", "SAMPLER_METHODS"]

#: torch-optimizer names of the reference; only Adam is ported so far
FIRST_ORDER_METHODS = ("Adam", "AdamW", "Adamax", "NAdam", "RAdam",
                       "Adagrad", "Adadelta", "RMSprop", "SGD", "ASGD",
                       "Rprop")
#: scipy.optimize and sampler names the reference accepts; not ported yet
SCIPY_METHODS = ("BFGS", "L-BFGS-B", "LBFGS", "CG", "SLSQP", "Nelder-Mead",
                 "Powell", "Newton-CG", "TNC", "trust-constr")
SAMPLER_METHODS = ("random", "grid", "uniform", "TPE")


class OptResult(Dict[str, Any]):
    """Dict result with attribute access (param/loss/best_iter/history)."""

    __getattr__ = dict.__getitem__


class Adam:
    """optax ``adam(exponential_decay(lr, lr_step, lr_decay, staircase))``.

    ``lr`` may be a Python number or a 0-dim tensor.
    """

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

    def init(self, x: torch.Tensor):
        return {"mu": torch.zeros_like(x), "nu": torch.zeros_like(x)}

    def step(self, x: torch.Tensor, grad: torch.Tensor, state: dict,
             count: int) -> torch.Tensor:
        """One update from step ``count`` (0-based); returns the new iterate
        and updates ``state`` in place."""
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * grad + b1 * state["mu"]
        nu = (1 - b2) * (grad * grad) + b2 * state["nu"]
        state["mu"], state["nu"] = mu, nu
        c = count + 1
        mu_hat = mu / (1 - b1 ** c)
        nu_hat = nu / (1 - b2 ** c)
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return x + (-self.learning_rate(count)) * update


def make_optimizer(method: str, lr, lr_step: int, lr_decay: float) -> Adam:
    """The optimizer for ``method`` with a staircase step decay (lr drops by
    ``lr_decay`` every ``lr_step`` steps)."""
    if method not in FIRST_ORDER_METHODS:
        raise KeyError(f"Unsupported first-order method {method!r}")
    if method != "Adam":
        raise NotImplementedError(f"{method} is not ported yet; use Adam")
    return Adam(lr, lr_step, lr_decay)


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
    k-th iterate as ``params_history``.
    """
    lr_step = n_iter if lr_step is None else lr_step
    opt = make_optimizer(method, lr, lr_step, lr_decay)
    dev, dt = x0.device, x0.dtype
    x = x0.detach().clone()
    state = opt.init(x)
    best_x = x
    best_loss = torch.full((), math.inf, dtype=dt, device=dev)
    best_it = torch.zeros((), dtype=torch.int32, device=dev)
    history = torch.empty((n_iter,), dtype=dt, device=dev)
    aux_history: Optional[Dict[str, torch.Tensor]] = None
    n_rec = -(-n_iter // record_every) if record_every > 0 else 0
    buf = torch.zeros((n_rec,) + tuple(x0.shape), dtype=dt, device=dev)
    steps = torch.arange(n_iter, dtype=torch.int32, device=dev)

    for it in range(n_iter):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = objective(xg)
            loss, aux = out if has_aux else (out, None)
            (grad,) = torch.autograd.grad(loss, xg)
        loss = loss.detach()
        history[it] = loss
        if aux is not None:
            if aux_history is None:
                aux_history = {k: torch.empty((n_iter,), dtype=v.dtype,
                                              device=dev)
                               for k, v in aux.items()}
            for k, v in aux.items():
                aux_history[k][it] = v.detach()
        better = loss < best_loss
        if track_best:
            best_x = torch.where(better, x, best_x)
        best_it = torch.where(better, steps[it], best_it)
        best_loss = torch.minimum(loss, best_loss)
        if record_every > 0 and it % record_every == 0:
            buf[it // record_every] = x
        x = opt.step(x, grad, state, it)
        if bounds is not None:
            x = torch.clamp(x, bounds[0], bounds[1])
    param = best_x if track_best else x
    return OptResult(param=param, loss=best_loss, best_iter=best_it,
                     history=history, aux_history=aux_history, last_param=x,
                     params_history=buf if record_every > 0 else None)
