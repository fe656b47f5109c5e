"""Per-frame evaluation work shared by the solver facades.

PyTorch counterpart of the JAX package's ``solver/programs.py``: the
clipped IWE, the event mask, the FWL metric, the flow-error pairs and the
render bundle.  As the JAX package keeps one ``jax.jit`` program per shape
(``functools.lru_cache``'d factories), the ``jit_*`` factories here keep
one :class:`~event_based_bos_tpu_torch.graphs.CapturedProgram` per static
argument: on the card its first call per input shape (event capacity,
dtypes, the ROI crop) runs eagerly and captures the program, and later
calls copy their inputs into its buffers and replay; the public functions
of the same names without the prefix call them.  A host number (a scale,
a sign) reaches a program as a device scalar (rounded to float32 first
where the JAX package rounds it).  Every event image votes through the
CUDA vote kernel on the card (``ops/iwe.py::create_image_from_events``):
the event mask is one launch, the FWL metric two, and the visualizing
loop's render bundle two (its clipped IWE and its event mask).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..costs import normalized_image_variance
from ..graphs import CapturedProgram
from ..ops.flow import calculate_flow_error
from ..ops.iwe import create_eventmask, create_image_from_events
from ..ops.poisson import poisson_view
from ..ops.warp import warp_event
from ..types import Events

__all__ = ["clipped_iwe", "eventmask", "fwl", "fwl_device", "flow_error",
           "flow_error_pair", "flow_error_pair_device", "polar_planes",
           "render_bundle", "jit_clipped_iwe", "jit_eventmask", "jit_fwl",
           "jit_fwl_device", "jit_flow_error", "jit_flow_error_pair",
           "jit_flow_error_pair_device", "jit_render_bundle"]

Errors = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# the programs' bodies
# ---------------------------------------------------------------------------

def _clipped(ev: Events, max_scale, image_shape) -> torch.Tensor:
    im = create_image_from_events(ev, image_shape, sigma=0)
    return 255 - torch.clamp(max_scale * im, 0, 255).to(torch.uint8)


def _fwl(ev: Events, flow: torch.Tensor, image_shape,
         normalize_t: bool) -> torch.Tensor:
    iwe_orig = create_image_from_events(ev, image_shape, sigma=1)
    warped = warp_event(ev, flow, "dense-flow", direction="middle",
                        normalize_t=normalize_t)
    iwe = create_image_from_events(warped, image_shape, sigma=1)
    return normalized_image_variance({"orig_iwe": iwe_orig, "iwe": iwe})


def _fwl_device(ev: Events, est: torch.Tensor, scale, image_shape,
                normalize_t: bool, dtype) -> torch.Tensor:
    flow = (est.to(torch.float32) * scale).to(dtype)
    return _fwl(ev, flow, image_shape, normalize_t)


def _pair(gt, pred, ev: Events, image_shape, crop):
    x0, x1, y0, y1 = crop
    mask = create_eventmask(ev, image_shape)[:, x0:x1, y0:y1]
    return (calculate_flow_error(gt, pred),
            calculate_flow_error(gt, pred, event_mask=mask[None]))


def _pair_device(ev: Events, est, gt_c, err_scale, image_shape, crop):
    x0, x1, y0, y1 = crop
    pred_c = (est.to(torch.float32) * err_scale)[None, :, x0:x1, y0:y1]
    return _pair(gt_c.to(torch.float32)[None], pred_c, ev, image_shape, crop)


def _bundle(ev: Events, est, gt_flow, max_scale, est_scale, err_scale,
            image_shape, err_crop):
    est32 = est.to(torch.float32)
    est_scaled = est32 * est_scale
    mask = create_eventmask(ev, image_shape)
    out = {"clipped": _clipped(ev, max_scale, image_shape), "mask": mask,
           "poisson_est": poisson_view(est_scaled),
           "poisson_gt": poisson_view(gt_flow),
           "polar_est": polar_planes(est_scaled),
           "polar_gt": polar_planes(gt_flow)}
    if err_crop is not None:
        x0, x1, y0, y1 = err_crop
        pred_c = (est32 * err_scale)[None, :, x0:x1, y0:y1]
        gt_c = gt_flow[:, x0:x1, y0:y1].to(torch.float32)[None]
        m = mask[:, x0:x1, y0:y1][None]
        out["errors"] = (calculate_flow_error(gt_c, pred_c),
                         calculate_flow_error(gt_c, pred_c, event_mask=m))
    return out


# ---------------------------------------------------------------------------
# the kept programs, one per static argument (and per input shape)
# ---------------------------------------------------------------------------

def _kept(body, **static) -> CapturedProgram:
    return CapturedProgram(functools.partial(body, **static))


@functools.lru_cache(maxsize=None)
def jit_clipped_iwe(image_shape) -> CapturedProgram:
    """The kept clipped-IWE program: ``(ev, max_scale) → uint8``."""
    return _kept(_clipped, image_shape=image_shape)


@functools.lru_cache(maxsize=None)
def jit_eventmask(image_shape) -> CapturedProgram:
    """The kept event-mask program: ``ev → [1, H, W] bool``."""
    return _kept(create_eventmask, image_size=image_shape)


@functools.lru_cache(maxsize=None)
def jit_fwl(image_shape, normalize_t: bool) -> CapturedProgram:
    """The kept FWL program: ``(ev, flow) → FWL``."""
    return _kept(_fwl, image_shape=image_shape, normalize_t=normalize_t)


@functools.lru_cache(maxsize=None)
def jit_fwl_device(image_shape, normalize_t: bool, dtype) -> CapturedProgram:
    """The kept FWL program of the solve's device-resident unoriented
    flow: ``(ev, est, scale) → FWL`` of ``(est · scale)`` in ``dtype``."""
    return _kept(_fwl_device, image_shape=image_shape,
                 normalize_t=normalize_t, dtype=dtype)


@functools.lru_cache(maxsize=None)
def jit_flow_error(masked: bool) -> CapturedProgram:
    """The kept error program: ``(gt, pred[, mask]) → errors``."""
    if masked:
        return CapturedProgram(
            lambda gt, pred, mask: calculate_flow_error(gt, pred,
                                                        event_mask=mask))
    return CapturedProgram(lambda gt, pred: calculate_flow_error(gt, pred))


@functools.lru_cache(maxsize=None)
def jit_flow_error_pair(image_shape, crop) -> CapturedProgram:
    """The kept error-pair program: ``(gt, pred, ev) → (errors, masked
    errors)``."""
    return _kept(_pair, image_shape=image_shape, crop=crop)


@functools.lru_cache(maxsize=None)
def jit_flow_error_pair_device(image_shape, crop) -> CapturedProgram:
    """The kept error-pair program of the solve's device-resident flow:
    ``(ev, est, gt_c, err_scale) → (errors, masked errors)``."""
    return _kept(_pair_device, image_shape=image_shape, crop=crop)


@functools.lru_cache(maxsize=None)
def jit_render_bundle(image_shape, err_crop=None) -> CapturedProgram:
    """The kept render-bundle program: ``(ev, est, gt_flow, max_scale,
    est_scale, err_scale) →`` the planes of :func:`render_bundle`."""
    return _kept(_bundle, image_shape=image_shape, err_crop=err_crop)


def _f32(x) -> float:
    """A host number rounded to float32, as the JAX package passes it."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# the public functions
# ---------------------------------------------------------------------------

def clipped_iwe(ev: Events, image_shape, max_scale: float) -> torch.Tensor:
    """IWE render → inverted clipped uint8: clip, truncating uint8 cast,
    then ``255 − x``."""
    return jit_clipped_iwe(tuple(image_shape))(ev, float(max_scale))


def eventmask(ev: Events, image_shape) -> torch.Tensor:
    """``[1, H, W]`` bool mask of the pixels the events vote into."""
    return jit_eventmask(tuple(image_shape))(ev)


def fwl(ev: Events, flow: torch.Tensor, image_shape,
        normalize_t: bool) -> torch.Tensor:
    """FWL = Var(IWE_orig) / Var(IWE of the events warped by ``flow``)
    (< 1 is better), both IWEs blurred with σ = 1."""
    return jit_fwl(tuple(image_shape), bool(normalize_t))(ev, flow)


def fwl_device(ev: Events, est: torch.Tensor, scale: float, image_shape,
               normalize_t: bool, dtype: torch.dtype) -> torch.Tensor:
    """:func:`fwl` of the solve's device-resident unoriented flow ``est``
    times ``scale`` (rounded to float32: the GT-window time rescale and
    the orientation sign), computed in float32 and cast to ``dtype``."""
    return jit_fwl_device(tuple(image_shape), bool(normalize_t), dtype)(
        ev, est, _f32(scale))


def flow_error(gt: torch.Tensor, pred: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> Errors:
    """:func:`~event_based_bos_tpu_torch.ops.flow.calculate_flow_error` of
    ``[B, 2, H, W]`` flows, event-masked when ``mask`` is given."""
    if mask is None:
        return jit_flow_error(False)(gt, pred)
    return jit_flow_error(True)(gt, pred, mask)


def flow_error_pair(gt: torch.Tensor, pred: torch.Tensor, ev: Events,
                    image_shape, crop: Tuple[int, int, int, int]
                    ) -> Tuple[Errors, Errors]:
    """The (unmasked, event-masked) error dicts of ``[B, 2, h, w]`` flows
    already cropped to ``crop``; the event mask is cropped to match."""
    return jit_flow_error_pair(tuple(image_shape), tuple(crop))(gt, pred, ev)


def flow_error_pair_device(ev: Events, est: torch.Tensor, gt_c: torch.Tensor,
                           err_scale: float, image_shape,
                           crop: Tuple[int, int, int, int]
                           ) -> Tuple[Errors, Errors]:
    """The pair from the solve's full-frame unoriented flow ``est``, on its
    device: ``est`` in float32 times ``err_scale`` (the orientation sign),
    cropped to ``crop``, against the cropped GT ``gt_c`` in float32."""
    return jit_flow_error_pair_device(tuple(image_shape), tuple(crop))(
        ev, est, gt_c, float(err_scale))


def polar_planes(flow: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The HSV polar planes of a ``[2, H, W]`` flow in float32, non-finite
    components zeroed first: the OpenCV hue ``(atan2(fy, fx) + π)·(180/π)/2``
    truncated to uint8, and ``‖flow‖**0.5`` as float16 (≤ 5e-4 relative,
    under 0.13 of a uint8 step after the value plane's 255 scaling)."""
    fx = flow[0].to(torch.float32)
    fy = flow[1].to(torch.float32)
    fx = torch.where(torch.isfinite(fx), fx, 0.0)
    fy = torch.where(torch.isfinite(fy), fy, 0.0)
    magp = torch.sqrt(torch.sqrt(fx * fx + fy * fy))
    ang = (torch.atan2(fy, fx) + math.pi) * (180.0 / math.pi) / 2.0
    return ang.to(torch.uint8), magp.to(torch.float16)


def render_bundle(ev: Events, est: torch.Tensor, gt_flow: torch.Tensor,
                  image_shape, max_scale: float, est_scale: float,
                  err_scale: float,
                  err_crop: Optional[Tuple[int, int, int, int]] = None
                  ) -> Dict[str, object]:
    """Every per-frame visualization plane of the evaluation loop, on the
    inputs' device: the clipped IWE (``clipped``, uint8) and the event mask
    (``mask``, ``[1, H, W]`` bool) — one vote launch each on the card —,
    the uint8 Poisson views of the scaled estimate and of the GT
    (``poisson_est``, ``poisson_gt``) and their polar planes
    (``polar_est``, ``polar_gt``: :func:`polar_planes`).

    ``est`` is the unoriented (or host-scaled) flow; ``est_scale`` folds
    the GT-window time rescale and the orientation sign into the rendered
    estimate, both rounded to float32.  With ``err_crop`` the bundle also
    holds ``errors``, the (unmasked, event-masked) error dicts of the
    flows cropped to it, the estimate times ``err_scale`` (the sign, or
    the inverse time scale on the host-flow path): the same numbers as
    :func:`flow_error_pair`.  One kept program (:func:`jit_render_bundle`).
    """
    crop = None if err_crop is None else tuple(err_crop)
    return jit_render_bundle(tuple(image_shape), crop)(
        ev, est, gt_flow, float(max_scale), _f32(est_scale),
        _f32(err_scale))
