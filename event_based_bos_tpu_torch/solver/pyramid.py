"""Pyramidal (coarse-to-fine) joint patch solver — the flagship model.

PyTorch counterpart of the JAX package's ``solver/pyramid.py``.  Square
patches of size 64 → 8 halving per scale (patch == stride), per-scale
iterations ``n_iter // (n_scales − scale_index + 1)``, Adam on the dense
objective at each scale, the coarser result upsampled as the next scale's
start.  The per-frame IWE cache can be supplied (``cache=``), which is how
the vote kernel runs as its own step ahead of the solve.

Not ported yet: ``restrict_to_roi`` and multi-start (``n_restarts > 1``
raises).
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
           "solve_pyramid", "estimate_frame", "update_coarse_from_fine"]


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
    # > 0 records the parameter iterate every ``record_evolution`` steps
    # into ``aux["params_history"]``
    record_evolution: int = 0
    # multi-start is not ported yet: values > 1 raise
    n_restarts: int = 1

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
    """
    gen = spec.gen
    dev = histogram.device
    measured = measured_increment(histogram, weights) * mask
    grids = pyramid_grids(spec)
    iters = scale_iterations(spec)

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
        ops = dense_operators(grid, gen.dtype, dev)

        def objective(p, _grid=grid, _ops=ops):
            return dense_objective(p, measured, gx, gy, weight_inverse, mask,
                                   _grid, gen, weights=weights,
                                   operators=_ops)

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
    # select (not multiply) so outside-ROI pixels are exactly +0.0
    dense_flow = torch.where(mask != 0,
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
                                    operators=fine_ops) * mask
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
    """
    if spec.n_restarts > 1 and init_params is None and prev_params is None:
        raise NotImplementedError("n_restarts > 1 is not ported yet")
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
    return solve_pyramid(hist, weights, weight_inverse, gx, gy, mask,
                         generator, spec, prev_params, init_params, lr=lr)


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
