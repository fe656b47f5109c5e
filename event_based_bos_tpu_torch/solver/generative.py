"""Generative-model building blocks (EKLT-style) of the patch solvers.

PyTorch counterpart of the JAX package's ``solver/generative.py``:

  * :func:`iwe_cache` — the per-frame signed histogram and weight maps; its
    vote is the CUDA kernel of :mod:`event_based_bos_tpu_torch.ops.iwe_cuda`
    on a GPU tensor (the kernel's plain version on a CPU tensor);
  * :func:`measured_increment` — the normalized measurement;
  * :func:`patch_to_dense` — patch grid → dense interpolation as two
    matmuls, with the operators built once per scale (:func:`dense_operators`)
    so the optimizer loop does no host→device copy;
  * :func:`predict_increment` — the generative model ``v·∇I`` with the
    per-pixel pattern-shift warp;
  * :func:`dense_objective` — the full objective with the hybrid cost.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import costs as costs_mod
from ..device import resolve_device
from ..numerics import abs_
from ..ops.gradients import poisson_to_flow
from ..ops.image_warp import (_resize_matrix_np, warp_image_forward,
                              warp_image_stencil)
from ..ops.iwe import blur_operators, gaussian_blur
from ..ops.iwe_cuda import bilinear_vote_cuda, signed_vote_cuda
from ..types import Events, PatchGrid

__all__ = ["GenerativeSpec", "iwe_cache_from_votes", "iwe_cache",
           "measured_increment", "dense_operators", "patch_to_dense",
           "patch_flow_of", "params_to_fields", "predict_increment",
           "dense_objective", "initialize_params"]

NORM_EPS = 1e-4  # prediction L2-normalization epsilon


def _safe_frobenius(x: torch.Tensor) -> torch.Tensor:
    """Frobenius norm with a zero subgradient at an exactly-zero input."""
    sq = torch.sum(x * x)
    zero = sq == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))


@dataclasses.dataclass(frozen=True)
class GenerativeSpec:
    """Static configuration of the generative model.

    Field meanings track the ``generative_ml`` YAML section.  The JAX
    package's ``compute_dtype``, ``warp_compute_bf16`` and ``pallas_iwe``
    are not here: the first two are not ported yet, and the vote's route
    follows the tensor's device.
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

@functools.lru_cache(maxsize=16)
def _cached_blur_operators(shape, sigma, mode, dtype, device):
    return blur_operators(shape, sigma, mode=mode, dtype=dtype, device=device)


def _blur(image: torch.Tensor, sigma, mode: str) -> torch.Tensor:
    """:func:`gaussian_blur` with its operators built once per shape, σ,
    mode, dtype and device (a build copies them from the host): the same
    matrices, so the same numbers."""
    if sigma is None or float(sigma) <= 0:
        return image
    ops = _cached_blur_operators(tuple(image.shape[-2:]), float(sigma), mode,
                                 image.dtype, image.device)
    return gaussian_blur(image, sigma, mode=mode, operators=ops)


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


def iwe_cache(ev: Events, spec: GenerativeSpec):
    """Per-frame event-histogram cache ``(histogram, weights|None,
    weight_inverse)``.

    The signed (or, with ``no_polarity``, unsigned) vote runs on the CUDA
    kernel for GPU tensors: the cache is a once-per-frame constant, and
    events reach the solve only through it.
    """
    if spec.no_polarity:
        hist = bilinear_vote_cuda(ev, spec.image_size)
    else:
        hist = signed_vote_cuda(ev, spec.image_size)
    hist = hist.to(spec.dtype)
    return iwe_cache_from_votes(torch.stack([hist, torch.zeros_like(hist)]),
                                spec)


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
                    crop: Optional[Tuple[int, int, int, int]] = None):
    """The two interpolation operators ``(mh, mw_t)`` of
    :func:`patch_to_dense` for one grid.  Build them once per scale — each
    build copies from the host.

    The replicate padding of the patch grid is folded into the resize
    matrices in float64 (padded rows that repeat an edge row add their
    weights), so the dense field is two matmuls and nothing else.  Unlike a
    gather, whose backward scatters with atomics, the matmuls give the
    same gradient on every run.  ``out_size`` and ``crop`` select the
    matrices' rows and columns, as in :func:`patch_to_dense`.
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

    def folded(n, pad, up, first, last):
        src = np.clip(np.arange(-pad, n + pad), 0, n - 1)
        edge = np.zeros((n + 2 * pad, n))
        edge[np.arange(n + 2 * pad), src] = 1.0
        return _resize_matrix_np(n + 2 * pad, up)[first:last] @ edge

    mh = folded(gh, ph, up_h, h1 + x0, h1 + x1)
    mw = folded(gw, pw, up_w, w1 + y0, w1 + y1)
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
                     operators=None) -> Dict[str, torch.Tensor]:
    """Unfold the joint parameter field ``[n_dim, gh, gw]`` to dense fields:
    ``flow`` ``[2, H, W]``, plus ``pxy`` (optimize_warp) and ``intensity``
    (when a cost needs it), in one interpolation."""
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
    dense = patch_to_dense(torch.cat(fields, dim=0), grid,
                           operators=operators)
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
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Predicted brightness increment ``v·∇I``, L2-normalized (+eps).

    ``pxy`` (dense per-pixel translation) warps the gradients first — the
    background-pattern distortion term.  The norm has a zero subgradient
    at an all-zero prediction.
    """
    if spec.optimize_warp and pxy is not None:
        if spec.warp_stencil_radius > 0:
            gxy = warp_image_stencil(torch.stack([gx, gy]), pxy,
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
    pred = pred / (_safe_frobenius(pred) + NORM_EPS)
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
                    operators=None):
    """Full-image joint objective over the ``[n_dim, gh, gw]`` field:
    hybrid cost of prediction vs measurement with the masked flow / pxy /
    intensity terms.  Returns ``(loss, per-term dict)``."""
    patch_flow = patch_flow_of(params, spec)
    fields = params_to_fields(params, grid, spec, patch_flow=patch_flow,
                              operators=operators)
    pred = predict_increment(fields["flow"], gx, gy, spec, fields.get("pxy"),
                             weights, mask)
    arg = {
        "prediction": pred,
        "measurement": measured,
        "flow": fields["flow"] * mask,
        "weights": weight_inverse,
        "omit_boundary": True,
    }
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
