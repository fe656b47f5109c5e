"""Pyramidal (coarse-to-fine) joint patch solver — the flagship model.

PyTorch counterpart of the JAX package's ``solver/pyramid.py``.  Square
patches of size 64 → 8 halving per scale (patch == stride), per-scale
iterations ``n_iter // (n_scales − scale_index + 1)``, Adam on the dense
objective at each scale, the coarser result upsampled as the next scale's
start.  The per-frame IWE cache can be supplied (``cache=``), which is how
the vote kernel runs as its own step ahead of the solve.

Options: ``restrict_to_roi`` evaluates the objective on the
margin-expanded ROI box with the full-frame cost kept (see
:class:`PyramidSpec`); ``n_restarts > 1`` solves from that many random
starts and keeps the one with the lowest finest-scale loss; the
generative spec's ``compute_dtype`` runs the loop's interior in another
dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gradients import frame_gradients, poisson_to_flow
from ..ops.image_warp import resize_bilinear
from ..optim import run_first_order
from ..types import Events, PatchGrid
from .generative import (GenerativeSpec, dense_objective, dense_operators,
                         initialize_params, iwe_cache, measured_increment,
                         patch_to_dense)

__all__ = ["PyramidSpec", "pyramid_grids", "scale_iterations", "roi_mask",
           "roi_crop_box", "solve_pyramid", "estimate_frame",
           "restart_scores", "select_restart", "update_coarse_from_fine"]


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """Static pyramid-solver configuration."""

    gen: GenerativeSpec
    roi: Tuple[int, int, int, int]  # xmin, xmax, ymin, ymax
    coarsest_patch: int = 64
    finest_patch: int = 8
    n_iter: int = 600
    method: str = "Adam"
    lr: float = 0.05
    lr_decay: float = 0.1
    offset: Tuple[int, int] = (0, 0)
    track_best: bool = True
    # Speed mode: evaluate the objective only on the ROI box grown by
    # ``roi_margin`` (clamped to the frame) while keeping the full-frame
    # cost: the measurement keeps its full-frame normalization, the mean
    # costs (image_gradient, flow_norm, flow_norm_pxy) get area-rescaled
    # weights, TV and Charbonnier their full-frame divisors
    # (``arg["full_domain"]``), the mask ridge stays inside the box (margin
    # >= 2), and the induced 1-norm is invariant to the crop.  The
    # prediction's L2 normalizer adds the outside part sampled at stride
    # ``roi_norm_stride`` (0: box only).
    restrict_to_roi: bool = False
    roi_margin: int = 2
    roi_norm_stride: int = 4
    # > 0 records the parameter iterate every ``record_evolution`` steps
    # into ``aux["params_history"]``
    record_evolution: int = 0
    # Quality mode: > 1 solves from that many random coarsest-scale starts
    # and keeps the one whose finest scale reached the lowest loss.
    n_restarts: int = 1
    # "map" or "vmap": in the JAX package, sequential or batched restart
    # lanes.  The port accepts both and runs the lanes one after another
    # for either; the result is the same.
    restart_mode: str = "map"

    @property
    def n_scales(self) -> int:
        return int(math.log2(self.coarsest_patch / self.finest_patch)) + 1


def pyramid_grids(spec: PyramidSpec) -> List[PatchGrid]:
    """Patch grids coarsest → finest (patch == stride at every scale)."""
    grids = []
    for i in range(spec.n_scales):
        p = spec.coarsest_patch // (2 ** i)
        grids.append(PatchGrid(spec.gen.image_size, (p, p), (p, p),
                               spec.offset))
    return grids


def scale_iterations(spec: PyramidSpec) -> List[int]:
    """Per-scale iteration budget."""
    s = spec.n_scales
    return [spec.n_iter // (s - i + 1) for i in range(s)]


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def roi_mask(spec: PyramidSpec, dtype: Optional[torch.dtype] = None
             ) -> np.ndarray:
    """Dense {0,1} estimation mask over the ROI (a host array)."""
    dtype = dtype or spec.gen.dtype
    x0, x1, y0, y1 = spec.roi
    m = np.zeros(spec.gen.image_size, _NP_DTYPES[dtype])
    m[x0:x1, y0:y1] = 1
    return m


def _outside_strips(box, gx: torch.Tensor, gy: torch.Tensor,
                    gen: GenerativeSpec, stride: int,
                    weights: Optional[torch.Tensor] = None):
    """Decimated sample grids covering the frame outside ``box``, for
    :func:`..generative.outside_norm_sq`.

    The frame minus the box is cut into the full-width strips above and
    below it and the flanks left and right of it; the two flanks share
    rows, so their columns merge into one sample grid (one pair of
    interpolation matmuls a step).  Each is sampled at ``stride`` in both
    axes (offset ``stride // 2``) with area ``stride²`` a sample, and
    carries the products of the gradients there.  ``weights`` (the
    event-hist weight map) multiplies the prediction before its norm, so it
    folds into the products as w².  Returns a list, or None when nothing
    is sampled.
    """
    if not stride:
        return None
    h, w = gen.image_size
    x0, x1, y0, y1 = box
    rects = [(0, x0, [(0, w)]), (x1, h, [(0, w)]),
             (x0, x1, [(0, y0), (y1, w)])]
    dt = gen.compute_dtype or gen.dtype
    area = float(stride * stride)
    strips = []
    for r0, r1, cols in rects:
        ridx = np.arange(r0 + stride // 2, r1, stride)
        cidx = np.concatenate([np.arange(c0 + stride // 2, c1, stride)
                               for c0, c1 in cols])
        if len(ridx) == 0 or len(cidx) == 0:
            continue
        r = torch.as_tensor(ridx, device=gx.device)
        c = torch.as_tensor(cidx, device=gx.device)

        def sample(a, _r=r, _c=c):
            return a.index_select(0, _r).index_select(1, _c).to(dt)

        gxs, gys = sample(gx), sample(gy)
        if weights is not None:
            ws = sample(weights)
            gxs = gxs * ws
            gys = gys * ws
        strips.append((ridx, cidx, gxs * gxs, gxs * gys, gys * gys, area))
    return strips or None


def _restricted_weights(cost_weights, area_scale: float):
    """The cost weights of the box objective: the mean costs' weights times
    ``area_scale`` (box area / frame area), an ``"inv"`` weight as
    ``("inv", area_scale)``, the others as they are."""
    mean_costs = {"image_gradient", "flow_norm", "flow_norm_pxy"}

    def rescale(name, w):
        if name not in mean_costs:
            return w
        if w == "inv":
            return ("inv", area_scale)
        return w if isinstance(w, str) else w * area_scale

    return tuple((n, rescale(n, w)) for n, w in cost_weights)


def roi_crop_box(spec: PyramidSpec) -> Tuple[int, int, int, int]:
    """The ROI grown by ``roi_margin`` and clamped to the frame."""
    h, w = spec.gen.image_size
    m = spec.roi_margin
    return (max(0, spec.roi[0] - m), min(h, spec.roi[1] + m),
            max(0, spec.roi[2] - m), min(w, spec.roi[3] + m))


def solve_pyramid(histogram: torch.Tensor, weights: Optional[torch.Tensor],
                  weight_inverse: torch.Tensor, gx: torch.Tensor,
                  gy: torch.Tensor, mask: torch.Tensor,
                  generator: Optional[torch.Generator], spec: PyramidSpec,
                  prev_params: Optional[List[torch.Tensor]] = None,
                  init_params: Optional[torch.Tensor] = None,
                  lr=None):
    """Coarse-to-fine joint optimization on the inputs' device; returns
    ``(dense_flow, aux)``.

    ``aux`` carries the per-scale best parameter fields, loss histories and
    per-term cost histories.  With ``prev_params`` (a warm start) the
    coarsest scale starts from the previous frame's params and finer
    scales average the upsampled coarser result with the previous frame's
    same-scale params.  ``init_params`` pins the coarsest start; otherwise
    it is drawn from ``generator``.  The dense flow is exactly +0.0 outside
    the mask.

    With ``spec.restrict_to_roi`` the loop runs on the margin-expanded ROI
    box: the measurement is normalized over the full frame before the
    crop, and the outside part of the prediction norm is sampled from the
    uncropped gradients.  With ``gen.compute_dtype`` the loop's constant
    images are cast once; the parameters and the optimizer state stay in
    ``gen.dtype``.
    """
    gen = spec.gen
    dev = histogram.device
    measured = measured_increment(histogram, weights) * mask
    grids = pyramid_grids(spec)
    iters = scale_iterations(spec)

    roi_crop = None
    norm_strips = None
    mask_o = mask
    if spec.restrict_to_roi:
        h, w = gen.image_size
        roi_crop = roi_crop_box(spec)
        x0, x1, y0, y1 = roi_crop
        norm_strips = _outside_strips(roi_crop, gx, gy, gen,
                                      spec.roi_norm_stride, weights=weights)
        # the loop's constants, copied once into contiguous boxes (views
        # would make every step's ops stride over the full rows)
        measured, gx, gy, mask, weight_inverse = (
            a[x0:x1, y0:y1].contiguous()
            for a in (measured, gx, gy, mask, weight_inverse))
        weights = (None if weights is None
                   else weights[x0:x1, y0:y1].contiguous())
        area_scale = ((x1 - x0) * (y1 - y0)) / float(h * w)
        gen = dataclasses.replace(gen, cost_weights=_restricted_weights(
            gen.cost_weights, area_scale))

    cd = gen.compute_dtype or gen.dtype
    if gen.compute_dtype is not None:
        measured = measured.to(cd)
        gx = gx.to(cd)
        gy = gy.to(cd)
        mask = mask.to(cd)
        weight_inverse = weight_inverse.to(cd)
        weights = None if weights is None else weights.to(cd)

    params_per_scale: List[torch.Tensor] = []
    histories: List[torch.Tensor] = []
    term_histories: List[Dict[str, torch.Tensor]] = []
    evolution: List[torch.Tensor] = []
    params = None
    for i, (grid, n_it) in enumerate(zip(grids, iters)):
        if i == 0:
            if init_params is not None:
                x0 = init_params
            elif prev_params is not None:
                x0 = prev_params[0]
            else:
                x0 = initialize_params(generator, grid.shape, gen, dev)
        else:
            x0 = resize_bilinear(params, grid.shape)
            if prev_params is not None:
                x0 = (prev_params[i] + x0) / 2.0
        ops = dense_operators(grid, cd, dev, crop=roi_crop)
        strip_ops = (None if norm_strips is None else
                     [dense_operators(grid, cd, dev, rows=st[0], cols=st[1])
                      for st in norm_strips])

        def objective(p, _grid=grid, _ops=ops, _strip_ops=strip_ops):
            return dense_objective(p, measured, gx, gy, weight_inverse, mask,
                                   _grid, gen, weights=weights,
                                   operators=_ops, roi_crop=roi_crop,
                                   norm_strips=norm_strips,
                                   strip_operators=_strip_ops)

        result = run_first_order(
            objective, x0, n_it, method=spec.method,
            lr=spec.lr if lr is None else lr, lr_decay=spec.lr_decay,
            track_best=spec.track_best, has_aux=True,
            record_every=spec.record_evolution)
        params = result.param
        params_per_scale.append(params)
        histories.append(result.history)
        term_histories.append(result.aux_history)
        if spec.record_evolution > 0:
            evolution.append(result.params_history)

    if gen.poisson_model:
        patch_flow = poisson_to_flow(params[0], ksize=gen.sobel_ksize)
    elif gen.angle_model:
        patch_flow = torch.stack([torch.sin(params[0]), torch.cos(params[0])])
    else:
        patch_flow = params[:2]
    fine_ops = dense_operators(grids[-1], gen.dtype, dev)
    # select (not multiply) so outside-ROI pixels are exactly +0.0; the
    # uncropped mask, at full size
    dense_flow = torch.where(mask_o != 0,
                             patch_to_dense(patch_flow, grids[-1],
                                            operators=fine_ops), 0.0)
    aux = {
        "params_per_scale": params_per_scale,
        "loss_history": histories,
        "term_history": term_histories,
    }
    if spec.record_evolution > 0:
        aux["params_history"] = evolution
    if gen.optimize_warp:
        aux["pxy"] = patch_to_dense(params[-2:], grids[-1],
                                    operators=fine_ops) * mask_o
    return dense_flow, aux


def _on(a, device, dtype):
    return None if a is None else torch.as_tensor(a).to(device=device,
                                                        dtype=dtype)


def estimate_frame(ev: Optional[Events], frame, mask,
                   generator: Optional[torch.Generator], spec: PyramidSpec,
                   prev_params: Optional[List[torch.Tensor]] = None,
                   init_params: Optional[torch.Tensor] = None,
                   lr=None,
                   cache: Optional[Tuple[torch.Tensor, ...]] = None,
                   device=None):
    """Whole per-frame solve: gradients + IWE cache + pyramid optimization.

    Runs on the GPU unless ``device`` asks otherwise; ``frame``, ``mask``,
    ``init_params``, ``prev_params`` and ``cache`` (tensors or host arrays)
    are moved there, and ``ev`` must already live there.  ``cache`` is the
    ``(histogram, weights|None, weight_inverse)`` triple of
    :func:`event_based_bos_tpu_torch.solver.generative.iwe_cache`; when it
    is given the events are unused and ``ev`` may be None.  ``generator``
    (on the same device) draws the random coarsest-scale init unless
    ``init_params`` or ``prev_params`` pins it.

    With ``spec.n_restarts = R > 1`` and no pinned init, the generator
    draws R coarsest-scale inits in lane order before the first lane runs,
    and the R solves run one after another on the shared IWE cache and
    gradients (under either ``restart_mode``).  The returned flow and aux
    are those of the lane with the lowest score: the least finest-scale
    loss under ``track_best``, else the final one (ties: the lowest lane).
    """
    dev = resolve_device(device)
    gen = spec.gen
    frame = _on(frame, dev, gen.dtype)
    mask = _on(mask, dev, gen.dtype)
    gx, gy = frame_gradients(frame, ksize=gen.sobel_ksize,
                             use_log_intensity=gen.use_log_intensity)
    if cache is not None:
        hist, weights, weight_inverse = (_on(c, dev, gen.dtype)
                                         for c in cache)
    else:
        hist, weights, weight_inverse = iwe_cache(ev, gen)
    init_params = _on(init_params, dev, gen.dtype)
    if prev_params is not None:
        prev_params = [_on(p, dev, gen.dtype) for p in prev_params]
    if spec.n_restarts > 1 and init_params is None and prev_params is None:
        if spec.restart_mode not in ("map", "vmap"):
            raise ValueError("restart_mode must be 'map' or 'vmap', got "
                             f"{spec.restart_mode!r}")
        shape = pyramid_grids(spec)[0].shape
        inits = [initialize_params(generator, shape, gen, dev)
                 for _ in range(spec.n_restarts)]
        lanes = [solve_pyramid(hist, weights, weight_inverse, gx, gy, mask,
                               None, spec, init_params=x0, lr=lr)
                 for x0 in inits]
        return select_restart(lanes, spec.track_best)
    return solve_pyramid(hist, weights, weight_inverse, gx, gy, mask,
                         generator, spec, prev_params, init_params, lr=lr)


def restart_scores(lanes, track_best: bool) -> torch.Tensor:
    """``[R]`` scores of restart lanes ``(flow, aux)``: the least loss of
    each lane's finest scale under ``track_best`` (the iterate it
    returns), else its final loss."""
    hists = [aux["loss_history"][-1] for _flow, aux in lanes]
    return torch.stack([h.min() if track_best else h[-1] for h in hists])


def select_restart(lanes, track_best: bool):
    """The ``(flow, aux)`` of the lane with the lowest score, picked on the
    device (no host sync): every tensor of the result is that lane's."""
    best = torch.argmin(restart_scores(lanes, track_best)).view(1)

    def pick(*leaves):
        if torch.is_tensor(leaves[0]):
            return torch.stack(leaves).index_select(0, best)[0]
        if isinstance(leaves[0], dict):
            return {k: pick(*(d[k] for d in leaves)) for k in leaves[0]}
        if isinstance(leaves[0], (list, tuple)):
            return type(leaves[0])(pick(*xs) for xs in zip(*leaves))
        return leaves[0]

    return pick(*lanes)


def update_coarse_from_fine(params_per_scale: List[torch.Tensor],
                            spec: PyramidSpec) -> List[torch.Tensor]:
    """Downsample fine-scale params back onto coarser grids (feedback for
    next-frame warm starts)."""
    grids = pyramid_grids(spec)
    refined = [None] * len(params_per_scale)
    refined[-1] = params_per_scale[-1]
    for i in range(len(params_per_scale) - 1, 0, -1):
        refined[i - 1] = resize_bilinear(params_per_scale[i],
                                         grids[i - 1].shape)
    return refined
