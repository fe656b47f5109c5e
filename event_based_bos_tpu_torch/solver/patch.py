"""Tiled patch solvers: independent (``PatchEklt``) and joint
(``PatchEkltDependent``).

PyTorch counterpart of the JAX package's ``solver/patch.py``:

  * **Independent** — every patch window (measurement, gradients, weights)
    is cut once with ``Tensor.unfold`` and all patches' scalar objectives
    are optimized at once as one ``[n_patch, d]`` batch: the per-patch
    objective is ``torch.func.vmap``-ed, the gradient of the summed losses
    is each patch's own gradient, and the best iterate is tracked per
    patch (a :class:`..optim.FirstOrderLoop` with a vector loss).
  * **Joint** — all patch parameters form one ``[n_dim, gh, gw]`` field
    optimized against the full-image objective cropped to the ROI; inactive
    patches (outside the ROI or under the event threshold) are masked.

Both vote the IWE cache once a frame (one launch of the vote kernel on the
card).  A :class:`PatchProgram` keeps either solve from frame to frame.

The independent solve fits every patch of the grid and masks the inactive
ones afterwards.  Under a profiler its spans ``ebt.patch.cut`` (the patch
windows of the frame's constants) and ``ebt.patch.assemble`` (the masked
patch flow to the dense frame) name that work, and each solve adds to the
counters ``patch.fits`` (patches in the batch) and ``patch.active``
(patches whose centre lies in the ROI, from the grid on the host: with
``do_event_thresholding`` an upper bound of the patches that enter the
flow).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graphs import KeptSolve
from ..numerics import abs_
from ..ops.gradients import poisson_to_flow
from ..ops.image_warp import warp_image_shift
from ..optim import FirstOrderLoop
from ..types import Events, PatchGrid
from ..utils.tracing import count, span
from .generative import (NORM_EPS, GenerativeSpec, _safe_frobenius,
                         dense_operators, frame_constants, initialize_params,
                         iwe_cache_program, measured_increment,
                         patch_to_dense, predict_increment)

__all__ = ["PatchSpec", "extract_patches", "patch_event_counts",
           "active_patch_mask", "PatchProgram", "solve_patches_independent",
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


def _patch_constants(histogram, weights, weight_inverse, gx, gy,
                     spec: PatchSpec):
    """Every patch window of the frame's constants, cut once: the
    normalized measurement, the gradients, the inverse-event weights and
    the event-hist weights (None without them), ``[n_patch, ph, pw]``."""
    grid = spec.grid
    n = grid.shape[0] * grid.shape[1]

    def norm(p):
        p = p.reshape(n, -1)
        return torch.sqrt(torch.sum(p * p, dim=-1))

    hist_p = extract_patches(histogram, grid)
    w_p = None
    if weights is not None:
        w_p = extract_patches(weights, grid)
        hist_p = w_p * hist_p
    measured_p = hist_p / torch.clamp(norm(hist_p), min=1e-30)[:, None, None]
    return {"measured_p": measured_p, "gx_p": extract_patches(gx, grid),
            "gy_p": extract_patches(gy, grid),
            "wi_p": extract_patches(weight_inverse, grid), "w_p": w_p}


class PatchProgram:
    """The tiled solve for one spec, kept from frame to frame: the
    counterpart of the JAX package's jitted ``estimate_frame_patch``
    (independent) or ``estimate_frame_dependent`` (``joint``).

    Its IWE cache is a kept program (:func:`..generative.iwe_cache_program`,
    captured per event capacity), and a
    :class:`~event_based_bos_tpu_torch.graphs.KeptSolve` holds the frame's
    constants in buffers of its own with the loop over them: the patch
    windows and the active mask of the independent solve (its vmapped
    objective over every patch), or the measurement, gradients, weights
    and patch mask of the joint one (with the grid's interpolation
    operators).  On the card the loop's step is captured at the first solve
    and replayed after.  ``kept=False`` is a program used once (the
    per-call route): the cache runs op by op and the loop's graph is
    dropped after the solve.  Outputs are copies.
    """

    def __init__(self, spec: PatchSpec, joint: bool, kept: bool = True):
        self.spec = spec
        self.joint = joint
        self.kept = KeptSolve()
        self._keep = kept
        self._lr = None
        self._ops = None
        self.cache = iwe_cache_program(spec.gen) if kept else None
        #: patches whose centre lies in the ROI (the independent solve's
        #: ``patch.active`` a solve)
        self.roi_patches = (None if joint else
                            int(spec.grid.roi_mask(*spec.roi).sum()))

    def _build_independent(self) -> None:
        spec = self.spec
        bufs = self.kept.buffers

        def one(theta, m, a, b, wi, w):
            return _patch_objective(theta, m, a, b, wi, w, spec)

        batched = torch.func.vmap(one, in_dims=(
            0, 0, 0, 0, 0, None if bufs["w_p"] is None else 0))

        def objective(thetas):
            return batched(thetas, bufs["measured_p"], bufs["gx_p"],
                           bufs["gy_p"], bufs["wi_p"], bufs["w_p"])

        self.kept.loops.append(FirstOrderLoop(
            objective, spec.n_iter, spec.method, lr=spec.lr,
            lr_decay=spec.lr_decay, track_best=spec.track_best))

    def _build_joint(self, lr, device) -> None:
        spec = self.spec
        gen = spec.gen
        bufs = self.kept.buffers
        grid = spec.grid
        ops = self._ops = dense_operators(grid, gen.dtype, device)

        def objective(p):
            loss, _ = joint_objective(p, bufs["patch_mask"],
                                      bufs["measured"], bufs["gx"],
                                      bufs["gy"], bufs["weight_inverse"],
                                      grid, gen, spec.roi,
                                      weights=bufs["weights"], operators=ops)
            return loss

        self.kept.loops.append(FirstOrderLoop(
            objective, spec.n_iter, spec.method, lr=lr,
            lr_decay=spec.lr_decay, track_best=spec.track_best))
        self._lr = lr

    def solve_independent(self, histogram, weights, weight_inverse, gx, gy,
                          active):
        """:func:`solve_patches_independent` through this program."""
        spec = self.spec
        gen = spec.gen
        gh, gw = spec.grid.shape
        count("patch.fits", gh * gw)
        count("patch.active", self.roi_patches)
        with span("ebt.patch.cut"):
            consts = _patch_constants(histogram, weights, weight_inverse, gx,
                                      gy, spec)
        dim = (1 if gen.angle_model else 2) + (2 if gen.optimize_warp else 0)
        x0 = torch.zeros((gh * gw, dim), dtype=gen.dtype,
                         device=histogram.device)
        if gen.angle_model:
            x0[:, 0] = torch.pi
        try:
            if self.kept.bind(consts):
                self._build_independent()
            res = self.kept.loops[0].run(x0)
        finally:
            if not self._keep:
                self.kept.release()
        thetas = res.param
        if gen.angle_model:
            u, v = torch.sin(thetas[:, 0]), torch.cos(thetas[:, 0])
        else:
            u, v = thetas[:, 0], thetas[:, 1]
        patched = torch.stack([u, v]).reshape(2, gh, gw) * active[None]
        # a step's loss summed over the patches that enter the flow; the
        # loop's per-patch [n_iter, n_patch] history goes no further
        history = torch.mv(res.history, active.reshape(-1))
        return patched, {"losses": res.loss.reshape(gh, gw),
                         "thetas": thetas, "history": history}

    def solve_joint(self, histogram, weights, weight_inverse, gx, gy,
                    patch_mask, x0, lr):
        """:func:`solve_patches_joint` through this program."""
        spec = self.spec
        consts = {"measured": measured_increment(histogram, weights,
                                                 roi=spec.roi),
                  "gx": gx, "gy": gy, "weight_inverse": weight_inverse,
                  "weights": weights, "patch_mask": patch_mask}
        try:
            if self.kept.bind(consts):
                self._build_joint(lr, histogram.device)
            elif torch.is_tensor(lr) or lr != self._lr:
                self.kept.loops[0].set_learning_rate(lr)
                self._lr = lr
            result = self.kept.loops[0].run(x0)
        finally:
            if not self._keep:
                self.kept.release()
        params = result.param
        patch_flow, _ = _masked_patch_flow(params, patch_mask, spec.gen)
        dense = patch_to_dense(patch_flow, spec.grid, operators=self._ops)
        return dense, {"params": params, "history": result.history,
                       "loss": result.loss}


def _program_for(spec: PatchSpec, joint: bool,
                 program: Optional[PatchProgram]) -> PatchProgram:
    if program is None:
        return PatchProgram(spec, joint, kept=False)
    if program.spec != spec or program.joint != joint:
        raise ValueError("the patch program was built for another solve")
    return program


def solve_patches_independent(histogram: torch.Tensor,
                              weights: Optional[torch.Tensor],
                              weight_inverse: torch.Tensor, gx: torch.Tensor,
                              gy: torch.Tensor, active: torch.Tensor,
                              spec: PatchSpec,
                              program: Optional[PatchProgram] = None):
    """All patches at once → the masked ``[2, gh, gw]`` patch flow, plus
    each patch's best loss ``[gh, gw]`` and parameters ``[n_patch, d]``
    and the ``[n_iter]`` history of the loss summed over the active
    patches;
    through ``program`` (an independent :class:`PatchProgram` of ``spec``)
    or a program of its own used once."""
    return _program_for(spec, False, program).solve_independent(
        histogram, weights, weight_inverse, gx, gy, active)


def estimate_frame_patch(ev: Events, frame,
                         generator: Optional[torch.Generator],
                         spec: PatchSpec, device=None,
                         program: Optional[PatchProgram] = None):
    """Per-frame independent tiled solve → dense flow ``[2, H, W]`` (+aux).

    Runs on the GPU unless ``device`` asks otherwise.  Draws nothing:
    every patch starts at 0 (angle model: π); ``generator`` is accepted for
    a signature like the other estimators'.  ``program`` (an independent
    :class:`PatchProgram` of ``spec``) runs the IWE cache and the solve
    through its kept programs; without one the solve builds its own, used
    once.
    """
    dev = resolve_device(device)
    ev, gx, gy, hist, weights, weight_inverse = frame_constants(
        ev, frame, spec.gen, dev, None if program is None else program.cache)
    active = active_patch_mask(ev, spec)
    patched, aux = solve_patches_independent(hist, weights, weight_inverse,
                                             gx, gy, active, spec, program)
    with span("ebt.patch.assemble"):
        dense = patch_to_dense(patched, spec.grid)
    return dense, aux


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
                        init_params: Optional[torch.Tensor] = None,
                        program: Optional[PatchProgram] = None):
    """One joint optimization over the whole ``[n_dim, gh, gw]`` field, at
    learning rate ``lr`` (0.05, the reference's; not ``spec.lr``).  The
    poisson init is drawn from ``generator`` unless ``init_params`` pins
    it.  Returns the dense flow ``[2, H, W]`` and ``{params, history,
    loss}``.  The solve runs through ``program`` (a joint
    :class:`PatchProgram` of ``spec``), or through a program of its own
    used once."""
    gen = spec.gen
    dev = histogram.device
    program = _program_for(spec, True, program)
    x0 = (initialize_params(generator, spec.grid.shape, gen, dev)
          if init_params is None
          else torch.as_tensor(init_params).to(device=dev, dtype=gen.dtype))
    return program.solve_joint(histogram, weights, weight_inverse, gx, gy,
                               patch_mask, x0, lr)


def estimate_frame_dependent(ev: Events, frame,
                             generator: Optional[torch.Generator],
                             spec: PatchSpec,
                             init_params: Optional[torch.Tensor] = None,
                             device=None,
                             program: Optional[PatchProgram] = None):
    """Per-frame joint tiled solve → dense flow ``[2, H, W]`` (+aux).  Runs
    on the GPU unless ``device`` asks otherwise; ``program`` (a joint
    :class:`PatchProgram` of ``spec``) as in :func:`estimate_frame_patch`."""
    dev = resolve_device(device)
    ev, gx, gy, hist, weights, weight_inverse = frame_constants(
        ev, frame, spec.gen, dev, None if program is None else program.cache)
    active = active_patch_mask(ev, spec)
    return solve_patches_joint(hist, weights, weight_inverse, gx, gy, active,
                               generator, spec, init_params=init_params,
                               program=program)
