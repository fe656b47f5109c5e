"""Whole-ROI generative maximum-likelihood (GML) solver.

PyTorch counterpart of the JAX package's ``solver/gml.py``: one patch
covering the ROI, parameters ``[angle | vx, vy]`` (+ the global pattern
shift), fitted by

  * the torch-optimizer names → :func:`..optim.run_first_order`,
  * the scipy names → :func:`..optim.run_scipy_method` (L-BFGS,
    Nelder-Mead or Newton-CG by family),
  * the samplers → :func:`..optim.run_sampler` (random, grid, and the
    two-stage ``TPE`` stand-in), or the sequential TPE study of
    :mod:`..tpe` through :func:`make_host_tpe_solver` (the facade's route).

The IWE cache is voted once a frame (one launch of the vote kernel on the
card), however many times the objective is evaluated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..optim import (FIRST_ORDER_METHODS, SAMPLER_METHODS, SCIPY_METHODS,
                     run_first_order, run_sampler, run_scipy_method)
from ..types import Events
from .generative import (GenerativeSpec, frame_constants,
                         measured_increment, scalar_objective,
                         unfold_scalar_params)

__all__ = ["GmlSpec", "initialize_theta", "solve_gml", "estimate_frame_gml",
           "make_host_objective", "make_host_tpe_solver"]


@dataclasses.dataclass(frozen=True)
class GmlSpec:
    """Static whole-ROI solver configuration."""

    gen: GenerativeSpec
    roi: Tuple[int, int, int, int]
    method: str = "Adam"
    n_iter: int = 600
    lr: float = 0.01
    lr_decay: float = 0.1
    # box bounds per parameter for the samplers (``optimizer.parameters``)
    param_bounds: Tuple[Tuple[float, float], ...] = ()
    track_best: bool = True
    # > 0: record every k-th iterate for the DEBUG evolution video
    # (first-order methods only)
    record_evolution: int = 0

    def __post_init__(self):
        # a sampler draws every parameter from its box: a bounds/model
        # mismatch would otherwise fail deep inside the objective
        if self.method in SAMPLER_METHODS and (
                len(self.param_bounds) != self.gen.param_dim):
            gen = self.gen
            head = (["angle"] if gen.angle_model
                    else ["p_intensity"] if gen.poisson_model
                    else ["v_x", "v_y"])
            warp = ((["p_magn", "p_angle"] if gen.pxpy_as_anglemagn
                     else ["p_x", "p_y"]) if gen.optimize_warp else [])
            raise ValueError(
                f"sampler {self.method!r} needs a bounds box per model "
                f"parameter: this model (angle_model={gen.angle_model}, "
                f"poisson_model={gen.poisson_model}, "
                f"optimize_warp={gen.optimize_warp}) has "
                f"{gen.param_dim} parameters ({', '.join(head + warp)}) "
                f"but `optimizer.parameters` configures "
                f"{len(self.param_bounds)}")


def initialize_theta(generator: Optional[torch.Generator], spec: GmlSpec,
                     device=None) -> torch.Tensor:
    """Initial scalar parameter vector: angle π, a poisson base ~ U(−1, 1)
    from ``generator`` (on ``device``), or velocity 0; then a zero warp
    pair."""
    gen = spec.gen
    dev = resolve_device(device)
    if gen.angle_model:
        head = torch.full((1,), torch.pi, dtype=gen.dtype, device=dev)
    elif gen.poisson_model:
        if generator is None:
            raise ValueError("a torch.Generator is needed for the random "
                             "poisson init (or pass x0)")
        head = torch.rand((1,), generator=generator, dtype=gen.dtype,
                          device=dev) * 2.0 - 1.0
    else:
        head = torch.zeros((2,), dtype=gen.dtype, device=dev)
    if gen.optimize_warp:
        return torch.cat([head, head.new_zeros(2)])
    return head


def _roi_constants(histogram, weights, spec: GmlSpec):
    """The measurement and the event-hist weights over the ROI."""
    x0, x1, y0, y1 = spec.roi
    measured = measured_increment(histogram, weights, roi=spec.roi)
    weights_roi = None if weights is None else weights[x0:x1, y0:y1]
    return measured, weights_roi


def solve_gml(histogram: torch.Tensor, weights: Optional[torch.Tensor],
              weight_inverse: torch.Tensor, gx: torch.Tensor,
              gy: torch.Tensor, generator: Optional[torch.Generator],
              spec: GmlSpec, x0: Optional[torch.Tensor] = None,
              draws=None):
    """Fit the scalar parameters; returns ``(theta, result)``.

    ``generator`` draws the poisson init (unless ``x0`` pins it) or the
    sampler's trials (unless ``draws`` gives them, see
    :func:`..optim.run_sampler`).
    """
    gen = spec.gen
    dev = histogram.device
    measured, weights_roi = _roi_constants(histogram, weights, spec)

    def objective(theta):
        loss, _terms = scalar_objective(theta, measured, gx, gy,
                                        weight_inverse, spec.roi, gen,
                                        weights_roi=weights_roi)
        return loss

    if spec.method in SAMPLER_METHODS:
        lo = [b[0] for b in spec.param_bounds]
        hi = [b[1] for b in spec.param_bounds]
        result = run_sampler(objective, (lo, hi), spec.n_iter, spec.method,
                             generator, draws=draws, device=dev)
        return result.param, result
    if x0 is None:
        x0 = initialize_theta(generator, spec, dev)
    if spec.method in FIRST_ORDER_METHODS:
        result = run_first_order(objective, x0, spec.n_iter, spec.method,
                                 lr=spec.lr, lr_decay=spec.lr_decay,
                                 track_best=spec.track_best,
                                 record_every=spec.record_evolution)
    elif spec.method in SCIPY_METHODS:
        result = run_scipy_method(objective, x0, spec.n_iter, spec.method)
    else:
        raise KeyError(f"Unknown optimizer method {spec.method!r}")
    return result.param, result


def _constant_flow(theta: torch.Tensor, gen: GenerativeSpec):
    vx, vy, _pxy = unfold_scalar_params(theta, gen)
    return torch.stack([vx, vy])[:, None, None].expand(
        (2,) + tuple(gen.image_size))


def estimate_frame_gml(ev: Events, frame, generator: Optional[torch.Generator],
                       spec: GmlSpec, x0=None, draws=None, device=None):
    """Whole per-frame GML solve → constant flow ``[2, H, W]`` (+aux).

    Runs on the GPU unless ``device`` asks otherwise; the events, the frame
    and ``x0`` are moved there.  The fitted (vx, vy) is broadcast over the
    image (a view).  ``aux``: ``theta``, ``loss``, ``history``, with
    ``spec.record_evolution`` ``theta_history``, and with L-BFGS the line
    search's ``host_reads``.
    """
    dev = resolve_device(device)
    gen = spec.gen
    _ev, gx, gy, hist, weights, weight_inverse = frame_constants(ev, frame,
                                                                 gen, dev)
    if x0 is not None:
        x0 = torch.as_tensor(x0).to(device=dev, dtype=gen.dtype)
    theta, result = solve_gml(hist, weights, weight_inverse, gx, gy,
                              generator, spec, x0=x0, draws=draws)
    aux = {"theta": theta, "loss": result.loss, "history": result.history}
    if spec.record_evolution > 0 and result.get("params_history") is not None:
        aux["theta_history"] = result["params_history"]
    if "host_reads" in result:  # L-BFGS's line search reads on the host
        aux["host_reads"] = result["host_reads"]
    return _constant_flow(theta, gen), aux


def make_host_objective(spec: GmlSpec, device=None):
    """Per-frame host objective factory for host-driven studies.

    Returns ``obj_for(ev, frame) -> objective``, where ``objective`` maps a
    host ``(dim,)`` array to a float: the frame's constants (IWE cache,
    gradients, measurement) are prepared once on the device, and each call
    uploads the parameters, evaluates, and reads one number back.
    """
    dev = resolve_device(device)
    gen = spec.gen

    def obj_for(ev: Events, frame):
        _ev, gx, gy, hist, weights, weight_inverse = frame_constants(
            ev, frame, gen, dev)
        measured, weights_roi = _roi_constants(hist, weights, spec)

        def objective(x: np.ndarray) -> float:
            theta = torch.as_tensor(np.asarray(x)).to(device=dev,
                                                      dtype=gen.dtype)
            with torch.no_grad():
                loss, _terms = scalar_objective(
                    theta, measured, gx, gy, weight_inverse, spec.roi, gen,
                    weights_roi=weights_roi)
            return float(loss)

        return objective

    return obj_for


def make_host_tpe_solver(spec: GmlSpec, device=None):
    """The sequential TPE study of :mod:`..tpe` over the box
    ``spec.param_bounds``, driven from the host with one device
    evaluation and one read per trial.  Returns
    ``solve(ev, frame, seed) -> (flow, aux)``."""
    from ..tpe import run_tpe

    dev = resolve_device(device)
    gen = spec.gen
    obj_for = make_host_objective(spec, dev)

    def solve(ev: Events, frame, seed: int):
        objective = obj_for(ev, frame)
        lo = [b[0] for b in spec.param_bounds]
        hi = [b[1] for b in spec.param_bounds]
        result = run_tpe(objective, (lo, hi), spec.n_iter, seed=seed)
        theta = torch.as_tensor(result.param).to(device=dev, dtype=gen.dtype)
        aux = {"theta": theta, "loss": result.loss,
               "history": torch.as_tensor(result.history).to(
                   device=dev, dtype=gen.dtype),
               "host_reads": len(result.history)}  # one a trial
        return _constant_flow(theta, gen), aux

    return solve
