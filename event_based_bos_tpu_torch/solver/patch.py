"""Tiled patch solvers: independent (``PatchEklt``) and joint
(``PatchEkltDependent``).

PyTorch counterpart of the JAX package's ``solver/patch.py``:

  * **Independent** — every patch window (measurement, gradients, weights)
    is cut once with ``Tensor.unfold`` and all patches' scalar objectives
    are optimized at once as one ``[n_patch, d]`` batch: the per-patch
    objective is ``torch.func.vmap``-ed, the gradient of the summed losses
    is each patch's own gradient, and the best iterate is tracked per
    patch (:func:`..optim.run_first_order` with a vector loss).
  * **Joint** — all patch parameters form one ``[n_dim, gh, gw]`` field
    optimized against the full-image objective cropped to the ROI; inactive
    patches (outside the ROI or under the event threshold) are masked.

Both vote the IWE cache once a frame (one launch of the vote kernel on the
card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..numerics import abs_
from ..ops.gradients import poisson_to_flow
from ..ops.image_warp import warp_image_shift
from ..optim import run_first_order
from ..types import Events, PatchGrid
from .generative import (NORM_EPS, GenerativeSpec, _safe_frobenius,
                         dense_operators, frame_constants, initialize_params,
                         measured_increment, patch_to_dense,
                         predict_increment)

__all__ = ["PatchSpec", "extract_patches", "patch_event_counts",
           "active_patch_mask", "solve_patches_independent",
           "joint_objective", "solve_patches_joint", "estimate_frame_patch",
           "estimate_frame_dependent"]


@dataclasses.dataclass(frozen=True)
class PatchSpec:
    """Static tiled-solver configuration (the ``solver.patch_eklt`` YAML
    section)."""

    gen: GenerativeSpec
    roi: Tuple[int, int, int, int]
    patch_size: int = 4
    sliding_window: int = 2
    method: str = "Adam"
    n_iter: int = 600
    lr: float = 0.01
    lr_decay: float = 0.1
    do_event_thresholding: bool = False
    event_thres: int = 8
    track_best: bool = True

    @property
    def grid(self) -> PatchGrid:
        p, s = self.patch_size, self.sliding_window
        return PatchGrid(self.gen.image_size, (p, p), (s, s))


def _windows(t: torch.Tensor, dim: int, size: int, step: int,
             n: int) -> torch.Tensor:
    """``n`` windows of ``size`` along ``dim`` starting every ``step``, as
    an unfold view; where the grid's last start would run past the edge,
    that window starts at ``len − size`` instead (JAX's ``dynamic_slice``
    clamps its start)."""
    w = t.unfold(dim, size, step)
    if w.shape[dim] < n:
        last = t.narrow(dim, t.shape[dim] - size, size).unfold(dim, size,
                                                               size)
        w = torch.cat([w, last], dim)
    return w


def extract_patches(image: torch.Tensor, grid: PatchGrid) -> torch.Tensor:
    """All patch windows: ``[H, W] → [n_patch, ph, pw]`` (row-major over
    the grid)."""
    ph, pw = grid.patch_size
    sh, sw = grid.stride
    gh, gw = grid.shape
    rows = _windows(image, 0, ph, sh, gh)        # [gh, W, ph]
    both = _windows(rows, 1, pw, sw, gw)         # [gh, gw, ph, pw]
    return both.reshape(gh * gw, ph, pw)


def patch_event_counts(ev: Events, grid: PatchGrid) -> torch.Tensor:
    """Live-event count inside each patch window ``[gh, gw]`` (float32),
    from one histogram and its summed-area table."""
    h, w = grid.image_size
    dev = ev.x.device
    xi = torch.clamp(ev.x.to(torch.int32), 0, h - 1).to(torch.int64)
    yi = torch.clamp(ev.y.to(torch.int32), 0, w - 1).to(torch.int64)
    flat = torch.zeros((h * w,), dtype=torch.float32, device=dev)
    flat.index_add_(0, xi * w + yi, ev.valid.to(torch.float32))
    sat = torch.nn.functional.pad(
        torch.cumsum(torch.cumsum(flat.reshape(h, w), 0), 1), (1, 0, 1, 0))
    x_min, x_max, y_min, y_max = grid.bounds()

    def edge(b, n):
        return torch.as_tensor(np.clip(np.ceil(b).astype(np.int64), 0, n),
                               device=dev)

    x0, x1 = edge(x_min, h), edge(x_max, h)
    y0, y1 = edge(y_min, w), edge(y_max, w)
    return sat[x1, y1] - sat[x0, y1] - sat[x1, y0] + sat[x0, y0]


def active_patch_mask(ev: Events, spec: PatchSpec) -> torch.Tensor:
    """{0, 1} mask ``[gh, gw]`` of the patches estimated: center inside the
    ROI and, with ``do_event_thresholding``, more than ``event_thres``
    events."""
    grid = spec.grid
    roi = torch.as_tensor(grid.roi_mask(*spec.roi), device=ev.x.device)
    if spec.do_event_thresholding:
        roi = roi & (patch_event_counts(ev, grid) > spec.event_thres)
    return roi.to(spec.gen.dtype)


# ---------------------------------------------------------------------------
# Independent per-patch solver (PatchEklt)
# ---------------------------------------------------------------------------

def _patch_objective(theta, measured_p, gx_p, gy_p, wi_p, w_p,
                     spec: PatchSpec):
    """Scalar objective of one patch window: the gradients shifted by
    (p_x, p_y) inside the window, the prediction along (sin θ, cos θ) or
    (vx, vy), L2-normalized, the hybrid cost over the constant patch
    flow."""
    gen = spec.gen
    if gen.angle_model:
        vx, vy = torch.sin(theta[0]), torch.cos(theta[0])
        rest = theta[1:]
    else:
        vx, vy = theta[0], theta[1]
        rest = theta[2:]
    if gen.optimize_warp:
        shift = rest[:2]
        gx_p = warp_image_shift(gx_p, shift)
        gy_p = warp_image_shift(gy_p, shift)
    pred = vx * gx_p + vy * gy_p
    if gen.no_polarity:
        pred = abs_(pred)
    if w_p is not None:
        pred = pred * w_p
    pred = pred / (_safe_frobenius(pred) + NORM_EPS)
    shape = (2,) + tuple(gx_p.shape)
    arg = {"prediction": pred, "measurement": measured_p,
           "flow": torch.stack([vx, vy])[:, None, None].expand(shape),
           "weights": wi_p, "omit_boundary": True}
    if gen.optimize_warp:
        arg["pxy"] = rest[:2, None, None].expand(shape)
    loss, _ = gen.cost_fn()(arg)
    return loss


def solve_patches_independent(histogram: torch.Tensor,
                              weights: Optional[torch.Tensor],
                              weight_inverse: torch.Tensor, gx: torch.Tensor,
                              gy: torch.Tensor, active: torch.Tensor,
                              spec: PatchSpec):
    """All patches at once → the masked ``[2, gh, gw]`` patch flow, plus
    each patch's best loss ``[gh, gw]`` and parameters ``[n_patch, d]``."""
    gen = spec.gen
    grid = spec.grid
    gh, gw = grid.shape
    n = gh * gw

    def norm(p):
        p = p.reshape(n, -1)
        return torch.sqrt(torch.sum(p * p, dim=-1))

    hist_p = extract_patches(histogram, grid)
    w_p = None
    if weights is not None:
        w_p = extract_patches(weights, grid)
        hist_p = w_p * hist_p
    measured_p = hist_p / torch.clamp(norm(hist_p), min=1e-30)[:, None, None]
    gx_p = extract_patches(gx, grid)
    gy_p = extract_patches(gy, grid)
    wi_p = extract_patches(weight_inverse, grid)

    dim = (1 if gen.angle_model else 2) + (2 if gen.optimize_warp else 0)
    x0 = torch.zeros((n, dim), dtype=gen.dtype, device=histogram.device)
    if gen.angle_model:
        x0[:, 0] = torch.pi

    def one(theta, m, a, b, wi, w):
        return _patch_objective(theta, m, a, b, wi, w, spec)

    batched = torch.func.vmap(one, in_dims=(0, 0, 0, 0, 0,
                                            None if w_p is None else 0))

    def objective(thetas):
        return batched(thetas, measured_p, gx_p, gy_p, wi_p, w_p)

    res = run_first_order(objective, x0, spec.n_iter, spec.method,
                          lr=spec.lr, lr_decay=spec.lr_decay,
                          track_best=spec.track_best)
    thetas = res.param
    if gen.angle_model:
        u, v = torch.sin(thetas[:, 0]), torch.cos(thetas[:, 0])
    else:
        u, v = thetas[:, 0], thetas[:, 1]
    patched = torch.stack([u, v]).reshape(2, gh, gw) * active[None]
    return patched, {"losses": res.loss.reshape(gh, gw), "thetas": thetas}


def estimate_frame_patch(ev: Events, frame,
                         generator: Optional[torch.Generator],
                         spec: PatchSpec, device=None):
    """Per-frame independent tiled solve → dense flow ``[2, H, W]`` (+aux).

    Runs on the GPU unless ``device`` asks otherwise.  Draws nothing:
    every patch starts at 0 (angle model: π); ``generator`` is accepted for
    a signature like the other estimators'.
    """
    dev = resolve_device(device)
    ev, gx, gy, hist, weights, weight_inverse = frame_constants(
        ev, frame, spec.gen, dev)
    active = active_patch_mask(ev, spec)
    patched, aux = solve_patches_independent(hist, weights, weight_inverse,
                                             gx, gy, active, spec)
    return patch_to_dense(patched, spec.grid), aux


# ---------------------------------------------------------------------------
# Joint (dependent) solver
# ---------------------------------------------------------------------------

def _masked_patch_flow(params: torch.Tensor, patch_mask: torch.Tensor,
                       gen: GenerativeSpec):
    """Per-patch flow of the joint field with the inactive patches zeroed:
    the poisson potential is masked before the Sobel, the velocity after
    the angle transform.  Returns ``(patch_flow, masked potential | None)``.
    """
    if gen.poisson_model:
        potential = params[0] * patch_mask
        return poisson_to_flow(potential, ksize=gen.sobel_ksize), potential
    if gen.angle_model:
        return torch.stack([torch.sin(params[0]),
                            torch.cos(params[0])]) * patch_mask, None
    return params[:2] * patch_mask, None


def joint_objective(params: torch.Tensor, patch_mask: torch.Tensor,
                    measured: torch.Tensor, gx: torch.Tensor,
                    gy: torch.Tensor, weight_inverse: torch.Tensor,
                    grid: PatchGrid, spec_gen: GenerativeSpec,
                    roi: Tuple[int, int, int, int],
                    weights: Optional[torch.Tensor] = None, operators=None):
    """Joint objective with inactive-patch masking, evaluated on the ROI
    crop: the full-image prediction, then the hybrid cost over the ROI.
    ``operators`` is :func:`..generative.dense_operators`' result for the
    grid.  Returns ``(loss, per-term dict)``."""
    x0, x1, y0, y1 = roi
    patch_flow, potential = _masked_patch_flow(params, patch_mask, spec_gen)
    flow = patch_to_dense(patch_flow, grid, operators=operators)
    pxy = None
    if spec_gen.optimize_warp:
        pxy = patch_to_dense(params[-2:] * patch_mask, grid,
                             operators=operators)
    pred = predict_increment(flow, gx, gy, spec_gen, pxy, weights)
    arg = {
        "prediction": pred[x0:x1, y0:y1],
        "measurement": measured,
        "flow": flow[:, x0:x1, y0:y1],
        "weights": weight_inverse[x0:x1, y0:y1],
        "omit_boundary": True,
    }
    if pxy is not None:
        arg["pxy"] = pxy[:, x0:x1, y0:y1]
    if potential is not None and spec_gen.needs_intensity:
        arg["intensity"] = patch_to_dense(potential, grid,
                                          operators=operators)[x0:x1, y0:y1]
    return spec_gen.cost_fn()(arg)


def solve_patches_joint(histogram: torch.Tensor,
                        weights: Optional[torch.Tensor],
                        weight_inverse: torch.Tensor, gx: torch.Tensor,
                        gy: torch.Tensor, patch_mask: torch.Tensor,
                        generator: Optional[torch.Generator],
                        spec: PatchSpec, lr: float = 0.05,
                        init_params: Optional[torch.Tensor] = None):
    """One joint optimization over the whole ``[n_dim, gh, gw]`` field, at
    learning rate ``lr`` (0.05, the reference's; not ``spec.lr``).  The
    poisson init is drawn from ``generator`` unless ``init_params`` pins
    it.  Returns the dense flow ``[2, H, W]`` and ``{params, history,
    loss}``."""
    gen = spec.gen
    grid = spec.grid
    dev = histogram.device
    measured = measured_increment(histogram, weights, roi=spec.roi)
    ops = dense_operators(grid, gen.dtype, dev)
    x0 = (initialize_params(generator, grid.shape, gen, dev)
          if init_params is None
          else torch.as_tensor(init_params).to(device=dev, dtype=gen.dtype))

    def objective(p):
        loss, _ = joint_objective(p, patch_mask, measured, gx, gy,
                                  weight_inverse, grid, gen, spec.roi,
                                  weights=weights, operators=ops)
        return loss

    result = run_first_order(objective, x0, spec.n_iter, spec.method, lr=lr,
                             lr_decay=spec.lr_decay,
                             track_best=spec.track_best)
    params = result.param
    patch_flow, _ = _masked_patch_flow(params, patch_mask, gen)
    dense = patch_to_dense(patch_flow, grid, operators=ops)
    return dense, {"params": params, "history": result.history,
                   "loss": result.loss}


def estimate_frame_dependent(ev: Events, frame,
                             generator: Optional[torch.Generator],
                             spec: PatchSpec,
                             init_params: Optional[torch.Tensor] = None,
                             device=None):
    """Per-frame joint tiled solve → dense flow ``[2, H, W]`` (+aux).  Runs
    on the GPU unless ``device`` asks otherwise."""
    dev = resolve_device(device)
    ev, gx, gy, hist, weights, weight_inverse = frame_constants(
        ev, frame, spec.gen, dev)
    active = active_patch_mask(ev, spec)
    return solve_patches_joint(hist, weights, weight_inverse, gx, gy, active,
                               generator, spec, init_params=init_params)
