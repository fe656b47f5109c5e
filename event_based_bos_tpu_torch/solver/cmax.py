"""Contrast-maximization (CMax) solver family — events-only flow estimation.

PyTorch counterpart of the JAX package's ``solver/cmax.py``: a candidate
motion warps the events, the warped events form a blurred image of warped
events (IWE), and Adam maximizes a contrast of that image (variance,
gradient magnitude), coarse-to-fine for the dense patch model.

With ``time_bins > 0`` the events are voted once per frame into per-bin
histograms (one launch of the vote kernel of ``ops/iwe_cuda.py`` on the
card), and the loop warps images instead of events: the dense model's IWE
is the binned stencil of
:func:`~event_based_bos_tpu_torch.ops.cmax_cuda.binned_warp_accumulate`
(the CUDA kernels on the card) or, with ``use_kernel=False``, the
:func:`~event_based_bos_tpu_torch.ops.image_warp.warp_image_stencil` sum
under autograd.  The two differ in the gradient at the hat's kinks (see
``ops/cmax_cuda.py``), as the JAX package's Pallas and jnp routes do.

The translation model takes every optimizer name: the first-order
methods, the scipy families and the samplers (``TPE`` as the two-stage
stand-in, as in the JAX package, where it runs inside a jitted program).
The dense model takes the first-order methods only; any other name raises
``KeyError`` there, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from .. import costs as costs_mod
from ..device import resolve_device
from ..ops.cmax_cuda import binned_warp_accumulate
from ..ops.events import _masked_min_max
from ..ops.image_warp import (resize_bilinear, shift_image_matrix,
                              warp_image_stencil)
from ..ops.iwe import bilinear_vote, blur_operators, gaussian_blur
from ..ops.iwe_cuda import hat_vote
from ..ops.warp import (calculate_reftime, warp_event_2dof,
                        warp_event_dense_flow)
from ..optim import (SAMPLER_METHODS, SCIPY_METHODS, run_first_order,
                     run_sampler, run_scipy_method)
from ..types import Events, PatchGrid
from .generative import dense_operators, patch_to_dense

__all__ = ["CmaxSpec", "contrast_loss", "time_bin_index",
           "binned_histograms", "binned_iwe",
           "scale_iterations", "solve_cmax_translation", "solve_cmax_dense",
           "estimate_frame_cmax"]


@dataclasses.dataclass(frozen=True)
class CmaxSpec:
    """Static CMax configuration.

    ``motion_model``: ``"2d-translation"`` fits one global (vx, vy);
    ``"dense-flow"`` fits a per-patch flow field coarse-to-fine.
    ``contrast_weights``: weighted contrast terms, maximized.
    ``smoothness`` adds the image_gradient TV prior on the dense flow.
    ``time_bins > 0`` scatters the events once into that many per-bin
    histograms and warps images in the loop; 0 warps every event exactly.
    ``warp_radius``: the binned stencil's radius, exact while every per-bin
    shift ``|dt·flow| <= warp_radius`` (for ``"middle"``, ``|dt| <= 0.5``).
    ``use_kernel``: the dense binned IWE through
    :func:`~event_based_bos_tpu_torch.ops.cmax_cuda.binned_warp_accumulate`
    (the counterpart of the JAX package's ``use_pallas``).
    """

    image_size: Tuple[int, int]
    roi: Optional[Tuple[int, int, int, int]] = None
    motion_model: str = "dense-flow"
    contrast_weights: Tuple[Tuple[str, float], ...] = (("image_variance",
                                                        1.0),)
    smoothness: float = 0.01
    iwe_sigma: float = 1.0
    direction: str = "middle"
    coarsest_patch: int = 64
    finest_patch: int = 16
    n_iter: int = 240
    method: str = "Adam"
    lr: float = 0.05
    lr_decay: float = 0.1
    param_bounds: Tuple[Tuple[float, float], ...] = ((-30.0, 30.0),
                                                     (-30.0, 30.0))
    dtype: torch.dtype = torch.float32
    time_bins: int = 16
    warp_radius: int = 2
    use_kernel: bool = True

    @property
    def n_scales(self) -> int:
        return int(math.log2(self.coarsest_patch / self.finest_patch)) + 1


def scale_iterations(spec: CmaxSpec) -> List[int]:
    """Adam steps per scale of the dense model, coarsest first:
    ``n_iter // (n_scales − i + 1)``."""
    s = spec.n_scales
    return [spec.n_iter // (s - i + 1) for i in range(s)]


def contrast_loss(iwe: torch.Tensor, spec: CmaxSpec) -> torch.Tensor:
    """Negated weighted contrast (so minimizers maximize sharpness)."""
    total = iwe.new_zeros(())
    for name, w in spec.contrast_weights:
        total = total + w * costs_mod.functions[name]({"iwe": iwe})
    return -total


def _blur_operators(shape, dtype, spec: CmaxSpec, device):
    """The IWE blur's operators, built once per solve (None without a
    blur)."""
    if not spec.iwe_sigma:
        return None
    return blur_operators(shape, spec.iwe_sigma, mode="reflect", dtype=dtype,
                          device=device)


def _roi_iwe(ev: Events, spec: CmaxSpec, blur=None) -> torch.Tensor:
    iwe = bilinear_vote(ev, spec.image_size)
    if spec.iwe_sigma:
        iwe = gaussian_blur(iwe, spec.iwe_sigma, mode="reflect",
                            operators=blur)
    if spec.roi is not None:
        x0, x1, y0, y1 = spec.roi
        iwe = iwe[x0:x1, y0:y1]
    return iwe


def time_bin_index(ev: Events, time_bins: int) -> torch.Tensor:
    """Each event's time bin ``[n]`` int32: ``time_bins`` equal bins over
    the valid events' time span."""
    tmin, tmax = _masked_min_max(ev.t, ev.valid)
    frac = torch.clamp((ev.t - tmin) / torch.clamp(tmax - tmin, min=1e-30),
                       0.0, 1.0)
    return torch.clamp(torch.floor(frac * time_bins).to(torch.int32), 0,
                       time_bins - 1)


def binned_histograms(ev: Events, spec: CmaxSpec,
                      crop: Optional[Tuple[int, int, int, int]] = None,
                      pitched: bool = False):
    """Scatter the events once into ``time_bins`` histograms ``[B, H, W]``
    and the per-bin ``dt`` ``[B]``.

    ``dt_b`` is the bin center in warp-normalized time relative to the
    direction: for ``"middle"`` the centers span (−0.5, 0.5).  ``crop =
    (x0, x1, y0, y1)`` gives that box of the histograms instead (the same
    numbers as cropping the full ones); ``pitched`` returns it in the
    stencil kernels' layout (that of ``ops/cmax_cuda.py::
    pitched_histograms``: rows on 16 bytes, pad columns 0).  All
    bins are one :func:`~event_based_bos_tpu_torch.ops.iwe_cuda.hat_vote`
    with the scatter's floor nudge: one kernel launch on the card (float32;
    cast to the events' dtype unless ``pitched``), its plain version on
    the CPU (in the events' dtype).
    """
    b = spec.time_bins
    bins = time_bin_index(ev, b)
    h, w = spec.image_size
    x0, x1, y0, y1 = crop if crop is not None else (0, h, 0, w)
    pitch = -(-(y1 - y0) // 4) * 4 if pitched else y1 - y0
    hists = hat_vote(ev.x, ev.y, None, (x1 - x0, y1 - y0), valid=ev.valid,
                     plane=bins, planes=b, origin=(x0, y0), pitch=pitch,
                     nudge=True)
    if not pitched and hists.dtype != ev.x.dtype:
        # the card votes in float32; the stencil route and the translation
        # fit compute in the events' dtype
        hists = hists.to(ev.x.dtype)
    alias = {"first": 0.0, "middle": 0.5, "last": 1.0}
    ref_frac = (alias.get(spec.direction, 0.5)
                if isinstance(spec.direction, str) else float(spec.direction))
    dt = (torch.arange(b, dtype=spec.dtype, device=ev.t.device) + 0.5) / b \
        - ref_frac
    return hists, dt


def _roi_box(spec: CmaxSpec):
    """The ROI widened by the warp radius (content can flow in from the
    margin), clipped to the frame; None without an ROI."""
    if spec.roi is None:
        return None
    h, w = spec.image_size
    x0, x1, y0, y1 = spec.roi
    r = spec.warp_radius
    return (max(0, x0 - r), min(h, x1 + r), max(0, y0 - r), min(w, y1 + r))


def binned_iwe(hists: torch.Tensor, dt: torch.Tensor, flow: torch.Tensor,
               spec: CmaxSpec, blur=None) -> torch.Tensor:
    """IWE of the binned events under a candidate dense flow.

    Bin b's mass moves by ``−dt_b·flow``: a stencil warp of its histogram.
    ``use_kernel`` takes :func:`binned_warp_accumulate` (its kernels on the
    card, its plain versions on the CPU); otherwise the
    :func:`warp_image_stencil` sum under autograd.  When ``hists``/``flow``
    cover only the widened ROI box (:func:`_roi_box`), the result is the
    ROI crop of the box.  ``blur`` is the blur's operators for the IWE's
    shape and dtype (:func:`~event_based_bos_tpu_torch.ops.iwe.blur_operators`).
    """
    if spec.use_kernel:
        iwe = binned_warp_accumulate(hists, flow, dt, spec.warp_radius)
    else:
        # [2, B, H, W]: bin b's shift −dt_b·flow
        shifts = -dt[:, None, None] * flow[:, None]
        iwe = torch.sum(warp_image_stencil(hists, shifts, spec.warp_radius),
                        dim=0)
    if spec.iwe_sigma:
        iwe = gaussian_blur(iwe, spec.iwe_sigma, mode="reflect",
                            operators=blur)
    if spec.roi is not None:
        x0, x1, y0, y1 = spec.roi
        if hists.shape[-2:] != tuple(spec.image_size):
            bx0, _bx1, by0, _by1 = _roi_box(spec)
            x0, x1, y0, y1 = x0 - bx0, x1 - bx0, y0 - by0, y1 - by0
        iwe = iwe[x0:x1, y0:y1]
    return iwe


def solve_cmax_translation(ev: Events,
                           generator: Optional[torch.Generator],
                           spec: CmaxSpec,
                           x0: Optional[torch.Tensor] = None, draws=None):
    """Global 2-DoF CMax fit; returns ``(motion [2], result)``.

    The motion is the *warp* parameter (events displaced by +v need warp
    −v to sharpen); the flow is its negative.  With ``time_bins > 0`` each
    bin's histogram shifts by ``dt_b·θ`` through banded matmuls
    (:func:`shift_image_matrix`, exact for any shift); ``time_bins = 0``
    warps every event.  The samplers draw inside the bounds box from
    ``generator`` (or take ``draws``, see :func:`..optim.run_sampler`); the
    scipy and first-order methods project every iterate onto it.
    """
    dev = ev.t.device
    # the IWE has the events' and the motion's promoted dtype
    blur = _blur_operators(spec.image_size,
                           torch.promote_types(ev.x.dtype, spec.dtype), spec,
                           dev)

    def finish(iwe):
        if spec.iwe_sigma:
            iwe = gaussian_blur(iwe, spec.iwe_sigma, mode="reflect",
                                operators=blur)
        if spec.roi is not None:
            x0_, x1_, y0_, y1_ = spec.roi
            iwe = iwe[x0_:x1_, y0_:y1_]
        return contrast_loss(iwe, spec)

    if spec.time_bins > 0:
        hists, dts = binned_histograms(ev, spec)

        def objective(theta):
            # event warp x' = x + dt·θ → bin content shifts by +dt_b·θ
            shifted = shift_image_matrix(hists, dts[:, None] * theta)
            return finish(torch.sum(shifted, dim=0))
    else:
        ref_time = calculate_reftime(ev, spec.direction)

        def objective(theta):
            warped = warp_event_2dof(ev, theta, ref_time, normalize_t=True)
            return contrast_loss(_roi_iwe(warped, spec, blur), spec)

    # configs that reuse a wider GML-style parameter block keep the leading
    # pair; a short block falls back to the default box
    pb = tuple(spec.param_bounds[:2])
    if len(pb) < 2:
        pb = pb + ((-30.0, 30.0),) * (2 - len(pb))
    if spec.method in SAMPLER_METHODS:
        result = run_sampler(objective, ([b[0] for b in pb],
                                         [b[1] for b in pb]),
                             spec.n_iter, spec.method, generator,
                             draws=draws, device=dev)
        return result.param, result
    lo = torch.tensor([b[0] for b in pb], dtype=spec.dtype, device=dev)
    hi = torch.tensor([b[1] for b in pb], dtype=spec.dtype, device=dev)
    if x0 is None:
        x0 = torch.zeros((2,), dtype=spec.dtype, device=dev)
    if spec.method in SCIPY_METHODS:
        result = run_scipy_method(objective, x0, spec.n_iter, spec.method,
                                  bounds=(lo, hi))
    else:
        result = run_first_order(objective, x0, spec.n_iter, spec.method,
                                 lr=spec.lr, lr_decay=spec.lr_decay,
                                 bounds=(lo, hi))
    return result.param, result


def solve_cmax_dense(ev: Events, generator: Optional[torch.Generator],
                     spec: CmaxSpec, init: Optional[torch.Tensor] = None):
    """Coarse-to-fine dense patch-flow CMax; returns ``(flow [2,H,W], aux)``.

    Per scale, a ``[2, gh, gw]`` patch-flow field is interpolated to dense
    and Adam minimizes the negated contrast of the blurred IWE plus a TV
    smoothness prior; the result, resized, starts the next finer scale.
    Scale i runs ``n_iter // (n_scales − i + 1)`` steps.  With ``time_bins
    > 0`` the objective is the binned one (:func:`binned_iwe`) on the
    widened ROI box; otherwise the events are warped one by one.
    ``init`` is the coarsest start (zeros by default).
    """
    dev = ev.t.device
    promoted = torch.promote_types(ev.x.dtype, spec.dtype)
    if spec.time_bins > 0:
        crop = _roi_box(spec)
        # the box only, voted once a frame; the kernel route in the layout
        # its kernels read (rows that start on 16 bytes)
        hists, dts = binned_histograms(ev, spec, crop=crop,
                                       pitched=spec.use_kernel)
        # the kernel route's IWE is float32
        blur = _blur_operators(hists.shape[-2:], torch.float32
                               if spec.use_kernel else promoted, spec, dev)
    else:
        ref_time = calculate_reftime(ev, spec.direction)
        crop = None
        blur = _blur_operators(spec.image_size, promoted, spec, dev)
    grids: List[PatchGrid] = []
    for i in range(spec.n_scales):
        p = spec.coarsest_patch // (2 ** i)
        grids.append(PatchGrid(spec.image_size, (p, p), (p, p)))
    iters = scale_iterations(spec)

    params = None
    histories = []
    for i, (grid, n_it) in enumerate(zip(grids, iters)):
        if i == 0:
            x0 = (init if init is not None
                  else torch.zeros((2,) + grid.shape, dtype=spec.dtype,
                                   device=dev))
        else:
            x0 = resize_bilinear(params, grid.shape)
        ops = dense_operators(grid, spec.dtype, dev, crop=crop)

        def objective(p, _grid=grid, _ops=ops):
            flow = patch_to_dense(p, _grid, operators=_ops)
            if spec.time_bins > 0:
                iwe = binned_iwe(hists, dts, flow, spec, blur)
            else:
                warped = warp_event_dense_flow(ev, flow, ref_time,
                                               normalize_t=True)
                iwe = _roi_iwe(warped, spec, blur)
            loss = contrast_loss(iwe, spec)
            if spec.smoothness:
                loss = loss + spec.smoothness * costs_mod.image_gradient(
                    {"flow": flow, "weights": 1.0, "omit_boundary": True})
            return loss

        result = run_first_order(objective, x0, n_it, spec.method,
                                 lr=spec.lr, lr_decay=spec.lr_decay)
        params = result.param
        histories.append(result.history)

    dense_flow = patch_to_dense(params, grids[-1])
    return dense_flow, {"params": params, "loss_history": histories}


def estimate_frame_cmax(ev: Events, frame,
                        generator: Optional[torch.Generator],
                        spec: CmaxSpec, device=None):
    """Per-frame CMax estimate → dense flow ``[2, H, W]`` (+aux).

    Runs on the GPU unless ``device`` asks otherwise; the events are moved
    there.  ``frame`` is accepted and ignored (CMax is events-only), for a
    signature like the generative solvers'.
    """
    dev = resolve_device(device)
    ev = Events(*(a.to(dev) for a in ev))
    if spec.motion_model in ("2d-translation", "rigid-optical-flow"):
        motion, result = solve_cmax_translation(ev, generator, spec)
        flow = (-motion)[:, None, None].expand(
            (2,) + tuple(spec.image_size))
        aux = {"motion": motion, "loss": result.loss,
               "history": result.history}
        if "host_reads" in result:  # L-BFGS's line search
            aux["host_reads"] = result["host_reads"]
        return flow, aux
    if spec.motion_model == "dense-flow":
        return solve_cmax_dense(ev, generator, spec)
    raise KeyError(f"motion_model {spec.motion_model!r} not supported")
