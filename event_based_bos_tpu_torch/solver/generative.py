"""Generative-model building blocks (EKLT-style) of the patch solvers.

PyTorch counterpart of the JAX package's ``solver/generative.py``:

  * :func:`iwe_cache` — the per-frame signed histogram and weight maps; its
    vote is the CUDA kernel of :mod:`event_based_bos_tpu_torch.ops.iwe_cuda`
    on a GPU tensor (the kernel's plain version on a CPU tensor); kept as a
    captured program per event capacity by :func:`iwe_cache_program`;
  * :func:`measured_increment` — the normalized measurement;
  * :func:`patch_to_dense` — patch grid → dense interpolation as two
    matmuls, with the operators built once per scale (:func:`dense_operators`)
    so the optimizer loop does no host→device copy;
    :func:`patch_to_dense_indexed` evaluates it at chosen rows × columns;
  * :func:`outside_norm_sq` — the prediction-norm correction from outside
    the ROI box of the restricted objective;
  * :func:`predict_increment` — the generative model ``v·∇I`` with the
    per-pixel pattern-shift warp;
  * :func:`dense_objective` — the full objective with the hybrid cost, over
    the full frame or (``roi_crop``) the margin-expanded ROI box;
  * :func:`scalar_objective` — the whole-ROI objective of 1–4 scalar
    parameters (:func:`unfold_scalar_params`, :func:`scalar_prediction`),
    the objective of the GML solver.

``GenerativeSpec.compute_dtype`` runs the objective's interior (the field
interpolation, the warp, the prediction) in another dtype, bfloat16 for
speed, with float32 reductions; ``warp_compute_bf16`` runs only the warp in
bfloat16.  The resize matmuls stay ``torch.matmul`` in that dtype.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import costs as costs_mod
from ..device import resolve_device
from ..graphs import CapturedProgram
from ..numerics import abs_
from ..ops.gradients import frame_gradients, poisson_to_flow
from ..ops.image_warp import (_resize_matrix_np, warp_image_forward,
                              warp_image_shift, warp_image_stencil)
from ..ops.iwe import cached_blur_operators as _cached_blur_operators
from ..ops.iwe import gaussian_blur
from ..ops.iwe_cuda import (bilinear_vote_cuda, polarity_iwe_cuda,
                            signed_vote_cuda)
from ..types import Events, PatchGrid

__all__ = ["GenerativeSpec", "polarity_votes", "iwe_cache_from_votes",
           "iwe_cache", "iwe_cache_program", "frame_constants", "measured_increment",
           "dense_operators", "patch_to_dense",
           "patch_to_dense_indexed", "outside_norm_sq", "patch_flow_of",
           "params_to_fields", "predict_increment", "dense_objective",
           "initialize_params", "scalar_param_dim", "unfold_scalar_params",
           "scalar_prediction", "scalar_objective"]

NORM_EPS = 1e-4  # prediction L2-normalization epsilon


def _safe_frobenius(x: torch.Tensor,
                    extra_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frobenius norm (of ``x`` and, squared, ``extra_sq`` beside it) with a
    zero subgradient at an exactly-zero input: the plain velocity model
    starts at a prediction of exactly zero, and the restricted objective's
    outside part is then zero too."""
    acc = _acc_dtype(x)
    sq = torch.sum((x * x).to(acc))
    if extra_sq is not None:
        sq = sq + extra_sq.to(acc)
    zero = sq == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq))
                       ).to(x.dtype)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """Reduction accumulator dtype: float32 for bfloat16 inputs."""
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


@dataclasses.dataclass(frozen=True)
class GenerativeSpec:
    """Static configuration of the generative model.

    Field meanings track the ``generative_ml`` YAML section.  The JAX
    package's ``pallas_iwe`` is not here: the vote's route follows the
    tensor's device.
    """

    image_size: Tuple[int, int]
    no_polarity: bool = False
    iwe_sigma: float = 2.0
    weight_by_event_hist: bool = False
    weight_sigma: float = 5.0
    weight_by_inverse_event_hist: bool = True
    optimize_warp: bool = True
    angle_model: bool = False
    poisson_model: bool = True
    use_log_intensity: bool = False
    # the two warp parameters as (p_magn, p_angle) instead of (p_x, p_y)
    # (YAML key ``px-py_as-angle-magnitude``); the scalar solvers only
    pxpy_as_anglemagn: bool = False
    sobel_ksize: int = 3
    cost_weights: Tuple[Tuple[str, object], ...] = (
        ("diff_norm", 1.0),
        ("image_gradient", 0.5),
        ("flow_norm_pxy", 0.1),
    )
    dtype: torch.dtype = torch.float32
    # Static bound on the per-pixel pattern shift |pxy| (px) for the
    # gather-free stencil warp; 0 selects the gather warp.
    warp_stencil_radius: int = 1
    # dtype of the objective's interior (field interpolation, gradient
    # warp, prediction); reductions accumulate in float32 for bfloat16, and
    # the parameters and optimizer state stay in ``dtype``.  None = dtype.
    compute_dtype: Optional[torch.dtype] = None
    # bfloat16 inside the pattern-shift warp stencil only
    warp_compute_bf16: bool = False

    @property
    def param_dim(self) -> int:
        """Parameters per patch: intensity|angle|[vx,vy]  (+2 when warping)."""
        base = 1 if (self.poisson_model or self.angle_model) else 2
        return base + (2 if self.optimize_warp else 0)

    def cost_fn(self):
        return costs_mod.hybrid_cost(dict(self.cost_weights))

    @property
    def needs_intensity(self) -> bool:
        return any("intensity" in name for name, _w in self.cost_weights)


# ---------------------------------------------------------------------------
# Measurement side
# ---------------------------------------------------------------------------

def _blur(image: torch.Tensor, sigma, mode: str) -> torch.Tensor:
    """:func:`gaussian_blur` with its operators built once per shape, σ,
    mode, dtype and device (a build copies them from the host): the same
    matrices, so the same numbers."""
    if sigma is None or float(sigma) <= 0:
        return image
    ops = _cached_blur_operators(tuple(image.shape[-2:]), float(sigma), mode,
                                 image.dtype, image.device)
    return gaussian_blur(image, sigma, mode=mode, operators=ops)


def polarity_votes(ev: Events, spec: GenerativeSpec) -> torch.Tensor:
    """The raw ``[2, H, W]`` (positive, negative) vote planes, the linear
    part of the IWE cache, in ``spec.dtype``: one launch of the vote kernel
    with polarity planes on the card (the scatter's floor nudge), its plain
    version on the CPU.  Votes of event shards sum to the votes of the
    whole batch (:mod:`event_based_bos_tpu_torch.parallel.sharding`)."""
    return polarity_iwe_cuda(ev, spec.image_size, nudge=True).to(spec.dtype)


def iwe_cache_from_votes(pol: torch.Tensor, spec: GenerativeSpec):
    """Nonlinear postprocessing of the ``[2, H, W]`` polarity votes: the
    histogram blur and the weight maps."""
    hist = pol[0] + pol[1] if spec.no_polarity else pol[0] - pol[1]
    weights = None
    if spec.weight_by_event_hist:
        weights = _blur(torch.abs(hist), spec.weight_sigma, "reflect")
    hist_s = (_blur(hist, spec.iwe_sigma, "reflect")
              if spec.iwe_sigma else hist)
    if spec.weight_by_inverse_event_hist:
        wi = _blur(torch.abs(hist), 10.0, "symmetric")
        # population std (ddof 0), as jnp.std
        hi = torch.mean(wi) + torch.std(wi, correction=0) / 2.0
        wi = torch.minimum(torch.clamp(wi, min=0.0), hi)
        wi = wi / torch.amax(wi)
        weight_inverse = 1.0 - 0.95 * wi
    else:
        weight_inverse = torch.ones_like(hist)
    return hist_s, weights, weight_inverse


def iwe_cache(ev: Events, spec: GenerativeSpec,
              program: Optional[CapturedProgram] = None):
    """Per-frame event-histogram cache ``(histogram, weights|None,
    weight_inverse)``.

    The signed (or, with ``no_polarity``, unsigned) vote runs on the CUDA
    kernel for GPU tensors: the cache is a once-per-frame constant, and
    events reach the solve only through it.  ``program`` (an
    :func:`iwe_cache_program` of ``spec``) computes it through that kept
    program: on the card captured at its first call per event capacity and
    replayed after (the same numbers).
    """
    if program is not None:
        return program(ev)
    return _iwe_cache(ev, spec)


def _iwe_cache(ev: Events, spec: GenerativeSpec):
    if spec.no_polarity:
        hist = bilinear_vote_cuda(ev, spec.image_size)
    else:
        hist = signed_vote_cuda(ev, spec.image_size)
    hist = hist.to(spec.dtype)
    return iwe_cache_from_votes(torch.stack([hist, torch.zeros_like(hist)]),
                                spec)


def iwe_cache_program(spec: GenerativeSpec) -> CapturedProgram:
    """The IWE cache of ``spec`` as a kept program (the vote, the blur and
    the weight maps), captured per event capacity: the counterpart of the
    JAX package's jitted ``iwe_cache`` (its facades' ``_cache_fn``)."""
    return CapturedProgram(functools.partial(_iwe_cache, spec=spec))


def frame_constants(ev: Events, frame, spec: GenerativeSpec, device,
                    cache_program: Optional[CapturedProgram] = None):
    """A frame's constants of the generative solvers on ``device``: the
    events moved there, the frame's gradients and the IWE cache (one
    vote; through ``cache_program`` when given, see :func:`iwe_cache`).
    Returns ``(ev, gx, gy, histogram, weights, weight_inverse)``."""
    frame = torch.as_tensor(frame).to(device=device, dtype=spec.dtype)
    gx, gy = frame_gradients(frame, ksize=spec.sobel_ksize,
                             use_log_intensity=spec.use_log_intensity)
    ev = Events(*(a.to(device) for a in ev))
    return (ev, gx, gy) + tuple(iwe_cache(ev, spec, cache_program))


def measured_increment(histogram: torch.Tensor,
                       weights: Optional[torch.Tensor],
                       roi: Optional[Tuple[int, int, int, int]] = None
                       ) -> torch.Tensor:
    """L2-normalized measured brightness increment (cropped to ``roi`` first
    when given)."""
    m = histogram
    w = weights
    if roi is not None:
        x0, x1, y0, y1 = roi
        m = m[x0:x1, y0:y1]
        w = None if w is None else w[x0:x1, y0:y1]
    if w is not None:
        m = w * m
    return m / torch.sqrt(torch.sum(m * m))


# ---------------------------------------------------------------------------
# Parameter field → dense fields
# ---------------------------------------------------------------------------

def dense_operators(grid: PatchGrid, dtype: torch.dtype, device,
                    out_size: Optional[Tuple[int, int]] = None,
                    crop: Optional[Tuple[int, int, int, int]] = None,
                    rows=None, cols=None):
    """The two interpolation operators ``(mh, mw_t)`` of
    :func:`patch_to_dense` for one grid.  Build them once per scale — each
    build copies from the host.

    The replicate padding of the patch grid is folded into the resize
    matrices in float64 (padded rows that repeat an edge row add their
    weights), so the dense field is two matmuls and nothing else.  Unlike a
    gather, whose backward scatters with atomics, the matmuls give the
    same gradient on every run.  ``out_size`` and ``crop`` select the
    matrices' rows and columns, as in :func:`patch_to_dense`; ``rows`` and
    ``cols`` (integer arrays of output positions) replace the crop's
    ranges, as in :func:`patch_to_dense_indexed`.
    """
    gh, gw = grid.shape
    ph = int(grid.patch_size[0] / 2 // grid.stride[0]) + 1
    pw = int(grid.patch_size[1] / 2 // grid.stride[1]) + 1
    out_h, out_w = out_size or grid.image_size
    up_h = (gh + 2 * ph) * grid.stride[0]
    up_w = (gw + 2 * pw) * grid.stride[1]
    h1 = up_h // 2 - out_h // 2
    w1 = up_w // 2 - out_w // 2
    x0, x1, y0, y1 = crop if crop is not None else (0, out_h, 0, out_w)
    rows = np.arange(x0, x1) if rows is None else np.asarray(rows)
    cols = np.arange(y0, y1) if cols is None else np.asarray(cols)

    def folded(n, pad, up, index):
        src = np.clip(np.arange(-pad, n + pad), 0, n - 1)
        edge = np.zeros((n + 2 * pad, n))
        edge[np.arange(n + 2 * pad), src] = 1.0
        return _resize_matrix_np(n + 2 * pad, up)[index] @ edge

    mh = folded(gh, ph, up_h, h1 + rows)
    mw = folded(gw, pw, up_w, w1 + cols)
    return tuple(torch.as_tensor(m).to(device=device, dtype=dtype)
                 for m in (mh, np.ascontiguousarray(mw.T)))


def patch_to_dense(field: torch.Tensor, grid: PatchGrid,
                   out_size: Optional[Tuple[int, int]] = None,
                   crop: Optional[Tuple[int, int, int, int]] = None,
                   operators=None) -> torch.Tensor:
    """Interpolate a per-patch field ``[..., gh, gw]`` to dense ``[..., H, W]``.

    Replicate-pad the patch grid by ``patch/2 // stride + 1``, bilinear
    resize by the stride factor (half-pixel sampling), center-crop to
    ``out_size`` (the image by default) — with the resize matrices sliced
    to the output rows/cols.  ``crop = (x0, x1, y0, y1)``, in output
    coordinates, restricts the result to that box.  ``operators`` is
    :func:`dense_operators`' result for the same grid, size and crop.
    """
    mh, mw_t = operators or dense_operators(grid, field.dtype, field.device,
                                            out_size, crop)
    return torch.matmul(torch.matmul(mh, field), mw_t)


def patch_to_dense_indexed(field: torch.Tensor, grid: PatchGrid, row_idx,
                           col_idx, operators=None) -> torch.Tensor:
    """:func:`patch_to_dense` evaluated only at the image rows ``row_idx``
    × columns ``col_idx`` (host integer arrays): the interpolation
    matrices are sliced to exactly those output positions of the full
    frame.  ``operators`` is :func:`dense_operators`' result for the same
    grid and indices."""
    mh, mw_t = operators or dense_operators(grid, field.dtype, field.device,
                                            rows=row_idx, cols=col_idx)
    return torch.matmul(torch.matmul(mh, field), mw_t)


def outside_norm_sq(patch_flow: torch.Tensor, grid: PatchGrid,
                    spec: GenerativeSpec, strips,
                    operators=None) -> torch.Tensor:
    """Squared prediction norm of the frame outside the ROI box, estimated
    on decimated sample grids.

    Each strip is ``(row_idx, col_idx, gxx, gxy, gyy, area_per_sample)``
    with ``g**`` the frame-gradient products at those pixels (see
    :func:`..pyramid._outside_strips`).  The prediction there is taken as
    the unwarped model ``flow·∇I``, so ``Σ pred²`` is the quadratic form
    ``fx²·gxx + 2·fx·fy·gxy + fy²·gyy`` of the interpolated flow.  The sum
    accumulates in float32 when the interior is bfloat16.  ``operators``
    holds one :func:`dense_operators` pair per strip.
    """
    if spec.compute_dtype is not None:
        patch_flow = patch_flow.to(spec.compute_dtype)
    acc = _acc_dtype(patch_flow)
    total = torch.zeros((), dtype=acc, device=patch_flow.device)
    for k, (row_idx, col_idx, gxx, gxy, gyy, area) in enumerate(strips):
        f = patch_to_dense_indexed(
            patch_flow, grid, row_idx, col_idx,
            operators=None if operators is None else operators[k])
        q = (f[0] * f[0] * gxx + 2.0 * f[0] * f[1] * gxy
             + f[1] * f[1] * gyy)
        total = total + area * torch.sum(q.to(acc))
    return total


def patch_flow_of(params: torch.Tensor, spec: GenerativeSpec) -> torch.Tensor:
    """Per-patch flow ``[2, gh, gw]`` from the joint parameter field."""
    if spec.poisson_model:
        return poisson_to_flow(params[0], ksize=spec.sobel_ksize)
    if spec.angle_model:
        return torch.stack([torch.sin(params[0]), torch.cos(params[0])])
    return params[:2]


def params_to_fields(params: torch.Tensor, grid: PatchGrid,
                     spec: GenerativeSpec,
                     patch_flow: Optional[torch.Tensor] = None,
                     operators=None,
                     crop: Optional[Tuple[int, int, int, int]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Unfold the joint parameter field ``[n_dim, gh, gw]`` to dense fields:
    ``flow`` ``[2, H, W]``, plus ``pxy`` (optimize_warp) and ``intensity``
    (when a cost needs it), in one interpolation in ``spec.compute_dtype``
    (over the ``crop`` box when given)."""
    if patch_flow is None:
        patch_flow = patch_flow_of(params, spec)
    fields = [patch_flow]
    names = ["flow"]
    if spec.optimize_warp:
        fields.append(params[-2:])
        names.append("pxy")
    if spec.poisson_model and spec.needs_intensity:
        fields.append(params[0:1])
        names.append("intensity")
    stacked = torch.cat(fields, dim=0)
    if spec.compute_dtype is not None:
        stacked = stacked.to(spec.compute_dtype)
    dense = patch_to_dense(stacked, grid, crop=crop, operators=operators)
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    for name, f in zip(names, fields):
        n = f.shape[0]
        out[name] = dense[pos:pos + n] if n > 1 else dense[pos]
        pos += n
    return out


# ---------------------------------------------------------------------------
# Prediction side
# ---------------------------------------------------------------------------

def predict_increment(flow: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                      spec: GenerativeSpec,
                      pxy: Optional[torch.Tensor] = None,
                      weights: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None,
                      extra_norm_sq: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Predicted brightness increment ``v·∇I``, L2-normalized (+eps).

    ``pxy`` (dense per-pixel translation) warps the gradients first — the
    background-pattern distortion term.  ``extra_norm_sq`` adds the
    squared norm from outside the computed box (:func:`outside_norm_sq`),
    so the normalizer keeps its full-frame meaning.  The norm has a zero
    subgradient at an all-zero prediction.
    """
    if spec.optimize_warp and pxy is not None:
        if spec.warp_stencil_radius > 0:
            stack = torch.stack([gx, gy])
            if spec.warp_compute_bf16:
                gxy = warp_image_stencil(
                    stack.to(torch.bfloat16), pxy.to(torch.bfloat16),
                    spec.warp_stencil_radius).to(stack.dtype)
            else:
                gxy = warp_image_stencil(stack, pxy,
                                         spec.warp_stencil_radius)
            gx, gy = gxy[0], gxy[1]
        else:
            gx = warp_image_forward(gx, pxy)
            gy = warp_image_forward(gy, pxy)
    pred = flow[0] * gx + flow[1] * gy
    if spec.no_polarity:
        pred = abs_(pred)
    if weights is not None:
        pred = pred * weights
    pred = pred / (_safe_frobenius(pred, extra_norm_sq) + NORM_EPS)
    if mask is not None:
        pred = pred * mask
    return pred


# ---------------------------------------------------------------------------
# Objective and initialization
# ---------------------------------------------------------------------------

def dense_objective(params: torch.Tensor, measured: torch.Tensor,
                    gx: torch.Tensor, gy: torch.Tensor,
                    weight_inverse: torch.Tensor, mask: torch.Tensor,
                    grid: PatchGrid, spec: GenerativeSpec,
                    weights: Optional[torch.Tensor] = None,
                    operators=None,
                    roi_crop: Optional[Tuple[int, int, int, int]] = None,
                    norm_strips=None, strip_operators=None):
    """Joint objective over the ``[n_dim, gh, gw]`` field: hybrid cost of
    prediction vs measurement with the masked flow / pxy / intensity
    terms.  Returns ``(loss, per-term dict)``.

    With ``roi_crop`` every dense field (and the constant images, which
    the caller crops) covers only the margin-expanded ROI box; the caller
    (:func:`..pyramid.solve_pyramid`) keeps the full-frame cost: the
    measurement's full-frame normalization, area-rescaled weights of the
    mean costs, ``arg["full_domain"]`` for TV and Charbonnier, and the
    prediction norm's outside part from ``norm_strips``
    (:func:`outside_norm_sq`, with ``strip_operators``).
    """
    patch_flow = patch_flow_of(params, spec)
    fields = params_to_fields(params, grid, spec, patch_flow=patch_flow,
                              operators=operators, crop=roi_crop)
    extra = (outside_norm_sq(patch_flow, grid, spec, norm_strips,
                             operators=strip_operators)
             if norm_strips else None)
    pred = predict_increment(fields["flow"], gx, gy, spec, fields.get("pxy"),
                             weights, mask, extra_norm_sq=extra)
    arg = {
        "prediction": pred,
        "measurement": measured,
        "flow": fields["flow"] * mask,
        "weights": weight_inverse,
        "omit_boundary": True,
    }
    if roi_crop is not None:
        arg["full_domain"] = spec.image_size
    if "pxy" in fields:
        arg["pxy"] = fields["pxy"] * mask
    if "intensity" in fields:
        arg["intensity"] = fields["intensity"] * mask
    return spec.cost_fn()(arg)


def initialize_params(generator: Optional[torch.Generator],
                      grid_shape: Tuple[int, int], spec: GenerativeSpec,
                      device=None) -> torch.Tensor:
    """Initial joint parameter field ``[n_dim, gh, gw]``: poisson base
    ~ U(−1, 1) per patch from ``generator``, angle = π, velocities and
    translations zero.  The generator must live on ``device``."""
    dev = resolve_device(device)
    gh, gw = grid_shape
    params = torch.zeros((spec.param_dim, gh, gw), dtype=spec.dtype,
                         device=dev)
    if spec.poisson_model:
        if generator is None:
            raise ValueError("a torch.Generator is needed for the random "
                             "poisson init (or pass init_params)")
        params[0] = torch.rand((gh, gw), generator=generator,
                               dtype=spec.dtype, device=dev) * 2.0 - 1.0
    elif spec.angle_model:
        params[0] = torch.pi
    return params


# ---------------------------------------------------------------------------
# Scalar (whole-ROI) objective
# ---------------------------------------------------------------------------

def scalar_param_dim(spec: GenerativeSpec) -> int:
    return spec.param_dim


def _clamped(t: torch.Tensor, i: int) -> torch.Tensor:
    """``t[i]`` with JAX's rule for a static index past the end: the read
    is clamped to the last element and its gradient dropped (the scatter
    that transposes the gather drops an out-of-bounds index).  The poisson
    model with ``optimize_warp`` has 3 parameters, read as (vx, vy) and a
    warp pair from ``theta[2:]`` (length 1)."""
    if i < t.shape[0]:
        return t[i]
    return t[-1].detach()


def unfold_scalar_params(theta: torch.Tensor, spec: GenerativeSpec):
    """Scalar parameter vector → ``(v_x, v_y, (p_x, p_y) | None)``.

    The angle model maps ``angle → (sin, cos)``; with
    ``pxpy_as_anglemagn`` the warp pair is ``(p_magn, p_angle) →
    (magn·sin, magn·cos)``.  The poisson model means nothing for one
    scalar velocity and is read as the plain (vx, vy) model, with JAX's
    clamped indices where the vector is shorter (see :func:`_clamped`).
    """
    if spec.angle_model:
        vx, vy = torch.sin(theta[0]), torch.cos(theta[0])
        rest = theta[1:]
    else:
        vx, vy = theta[0], _clamped(theta, 1)
        rest = theta[2:]
    if not spec.optimize_warp:
        return vx, vy, None
    a, b = rest[0], _clamped(rest, 1)
    if spec.pxpy_as_anglemagn:
        return vx, vy, (a * torch.sin(b), a * torch.cos(b))
    return vx, vy, (a, b)


def scalar_prediction(theta: torch.Tensor, gx: torch.Tensor,
                      gy: torch.Tensor, roi: Tuple[int, int, int, int],
                      spec: GenerativeSpec,
                      weights_roi: Optional[torch.Tensor] = None):
    """Normalized whole-ROI prediction for a scalar parameter vector: the
    full-size gradients shifted by (p_x, p_y), cropped to the ROI, dotted
    with the constant velocity, L2-normalized.  Returns ``(pred_roi, (vx,
    vy, pxy))``; shared with the evolution renderer."""
    x0, x1, y0, y1 = roi
    vx, vy, pxy = unfold_scalar_params(theta, spec)
    if pxy is not None:
        shift = torch.stack([pxy[0], pxy[1]])
        if spec.warp_stencil_radius > 0:
            # both images in one stencil pass: the same numbers as two
            gxw, gyw = warp_image_stencil(torch.stack([gx, gy]), shift,
                                          spec.warp_stencil_radius)
        else:
            gxw = warp_image_shift(gx, shift)
            gyw = warp_image_shift(gy, shift)
        gxw, gyw = gxw[x0:x1, y0:y1], gyw[x0:x1, y0:y1]
    else:
        gxw = gx[x0:x1, y0:y1]
        gyw = gy[x0:x1, y0:y1]
    pred = vx * gxw + vy * gyw
    if spec.no_polarity:
        pred = abs_(pred)
    if weights_roi is not None:
        pred = pred * weights_roi
    pred = pred / (_safe_frobenius(pred) + NORM_EPS)
    return pred, (vx, vy, pxy)


def scalar_objective(theta: torch.Tensor, measured_roi: torch.Tensor,
                     gx: torch.Tensor, gy: torch.Tensor,
                     weight_inverse: torch.Tensor,
                     roi: Tuple[int, int, int, int], spec: GenerativeSpec,
                     weights_roi: Optional[torch.Tensor] = None):
    """Whole-ROI objective over 1–4 scalar parameters: the hybrid cost of
    :func:`scalar_prediction` against the measurement, with the constant
    flow and translation over the ROI.  Returns ``(loss, per-term
    dict)``."""
    x0, x1, y0, y1 = roi
    pred, (vx, vy, pxy) = scalar_prediction(theta, gx, gy, roi, spec,
                                            weights_roi)
    shape = (2, x1 - x0, y1 - y0)
    arg = {
        "prediction": pred,
        "measurement": measured_roi,
        "flow": torch.stack([vx, vy])[:, None, None].expand(shape),
        "weights": weight_inverse[x0:x1, y0:y1],
        "omit_boundary": True,
    }
    if pxy is not None:
        arg["pxy"] = torch.stack([pxy[0], pxy[1]])[:, None, None].expand(
            shape)
    return spec.cost_fn()(arg)
