"""The bilinear event vote on the hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/iwe_pallas.py``: the same four entry
points (``hat_vote_image`` and the ``bilinear``/``signed``/``polarity``
wrappers) with the same semantics — invalid slots vote nothing, the
polarity sign is folded into the weight, and ``padding`` shifts the
coordinates and grows the image — plus :func:`hat_vote`, the one entry
behind them all and behind the CMax solver's time-binned histograms
(``solver/cmax.py::binned_histograms``).

:func:`hat_vote` reads the event record's own arrays (coordinates, validity
mask, polarity, weights, an optional plane index) and votes into ``P``
planes of an output box, in a row pitch the caller picks.  For a CUDA
tensor it launches ``csrc/hat_vote.cu`` (a memset of the output and one
thread per event with a global atomic add per corner vote; no temporaries
from the event record) and raises if it cannot; for a CPU tensor it runs
:func:`hat_vote_plain`, the torch scatter that repeats the kernel's
arithmetic and is its specification.  Integer coordinates give bit-equal
images on both; fractional ones agree to f32 summation order.  The kernel
votes in float32 (a float64 record is rounded to it); the plain version
computes in the coordinates' dtype.  Not differentiable — events enter the
solvers only through these per-frame constants.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .. import kernels
from ..types import Events

__all__ = ["vote_corners", "hat_vote", "hat_vote_plain", "hat_vote_image",
           "bilinear_vote_cuda", "signed_vote_cuda", "polarity_iwe_cuda"]

_EPS = 1e-6  # floor nudge of the scatter


def vote_corners(x, y, values, image_size, *, valid=None, sign=None,
                 polarity_planes=None, scale=1.0, plane=None, planes=1,
                 offset=(0.0, 0.0), origin=(0, 0), nudge=False):
    """The four corner votes of every event as the kernel forms them: a
    list of ``(plane, row, col, value, keep)`` tensors ``[n]`` in box
    coordinates, ``keep`` false where the corner does not vote (event
    invalid, value or weight zero, plane outside ``[0, planes)``, corner
    outside the box).  Computed in the coordinates' dtype; arguments as
    :func:`hat_vote`'s."""
    h, w = image_size
    org_r, org_c = origin
    dt = torch.promote_types(x.dtype, y.dtype)
    x, y = x.to(dt), y.to(dt)
    val = torch.full_like(x, float(scale))
    keep = (torch.ones_like(x, dtype=torch.bool) if valid is None
            else valid.to(torch.bool))
    if sign is not None:
        val = torch.where(sign > 0, val, -val)
    q = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    if polarity_planes is not None:
        q = torch.where(polarity_planes > 0, 0, 1)
        keep = keep & ((polarity_planes > 0) | (polarity_planes <= 0))
    if values is not None:
        val = val * values.to(dt)
    if plane is not None:
        q = plane.to(torch.int64)
    keep = keep & (val != 0) & (q >= 0) & (q < planes)
    xi = x + float(offset[0])
    yi = y + float(offset[1])
    fx = torch.floor(xi + _EPS) if nudge else torch.floor(xi)
    fy = torch.floor(yi + _EPS) if nudge else torch.floor(yi)
    # rows fx and fx + 1 must meet the box; NaN fails (and is dropped)
    ok = ((fx >= org_r - 1) & (fx <= org_r + h - 1)
          & (fy >= org_c - 1) & (fy <= org_c + w - 1))
    keep = keep & ok
    dx = xi - fx
    dy = yi - fy
    r0 = torch.where(ok, fx, float(org_r)).to(torch.int64) - org_r
    c0 = torch.where(ok, fy, float(org_c)).to(torch.int64) - org_c
    corners = []
    # the scatter's corner order (ops/iwe.py), so that the plain version
    # sums each pixel in the order the scatter did
    for dr, dc, wgt in ((0, 0, (1 - dx) * (1 - dy)), (1, 0, dx * (1 - dy)),
                        (0, 1, (1 - dx) * dy), (1, 1, dx * dy)):
        r = r0 + dr
        c = c0 + dc
        inb = keep & (r >= 0) & (r < h) & (c >= 0) & (c < w) & (wgt != 0)
        corners.append((q, r, c, wgt * val, inb))
    return corners


def _arguments(x, y, values, image_size, valid, sign, polarity_planes,
               plane, planes, origin, pitch):
    """Checks shared by both routes; returns ``(h, w, pitch, n_planes)``."""
    h, w = (int(s) for s in image_size)
    if h <= 0 or w <= 0:
        raise ValueError(f"image_size must be positive, got {image_size}")
    pitch = w if pitch is None else int(pitch)
    if pitch < w:
        raise ValueError(f"pitch {pitch} is narrower than the width {w}")
    if x.dim() != 1 or not x.is_floating_point():
        raise ValueError(f"x must be a 1-D float tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    for name, t in (("y", y), ("values", values), ("valid", valid),
                    ("sign", sign), ("polarity_planes", polarity_planes),
                    ("plane", plane)):
        if t is not None and (t.shape != x.shape or t.device != x.device):
            raise ValueError(f"{name} must match x in device and length")
    if sign is not None and polarity_planes is not None:
        raise ValueError("sign and polarity_planes exclude each other")
    if polarity_planes is not None:
        if plane is not None or planes not in (None, 2):
            raise ValueError("polarity_planes makes two planes of its own")
        planes = 2
    if planes is not None and planes < 1:
        raise ValueError(f"planes must be positive, got {planes}")
    if len(origin) != 2:
        raise ValueError(f"origin must be (row, col), got {origin}")
    return h, w, pitch, 1 if planes is None else int(planes)


def _shaped(out, w, planes):
    out = out[..., :w] if out.shape[-1] != w else out
    return out[0] if planes is None else out


def hat_vote_plain(x: torch.Tensor, y: torch.Tensor,
                   values: Optional[torch.Tensor],
                   image_size: Tuple[int, int], *,
                   valid: Optional[torch.Tensor] = None,
                   sign: Optional[torch.Tensor] = None,
                   polarity_planes: Optional[torch.Tensor] = None,
                   scale: float = 1.0,
                   plane: Optional[torch.Tensor] = None,
                   planes: Optional[int] = None,
                   offset: Tuple[float, float] = (0.0, 0.0),
                   origin: Tuple[int, int] = (0, 0),
                   pitch: Optional[int] = None,
                   nudge: bool = False) -> torch.Tensor:
    """:func:`hat_vote` as a torch scatter: the plain version of the CUDA
    kernel, with the kernel's arithmetic (:func:`vote_corners`), in the
    coordinates' dtype."""
    h, w, pitch, n_planes = _arguments(x, y, values, image_size, valid,
                                       sign, polarity_planes, plane, planes,
                                       origin, pitch)
    corners = vote_corners(x, y, values, (h, w), valid=valid, sign=sign,
                           polarity_planes=polarity_planes, scale=scale,
                           plane=plane, planes=n_planes, offset=offset,
                           origin=origin, nudge=nudge)
    flat = torch.zeros((n_planes * h * pitch,), dtype=corners[0][3].dtype,
                       device=x.device)
    for q, r, c, val, inb in corners:
        flat.index_add_(0, ((q * h + r) * pitch + c)[inb], val[inb])
    return _shaped(flat.view(n_planes, h, pitch), w,
                   2 if polarity_planes is not None else planes)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def hat_vote(x: torch.Tensor, y: torch.Tensor,
             values: Optional[torch.Tensor], image_size: Tuple[int, int], *,
             valid: Optional[torch.Tensor] = None,
             sign: Optional[torch.Tensor] = None,
             polarity_planes: Optional[torch.Tensor] = None,
             scale: float = 1.0,
             plane: Optional[torch.Tensor] = None,
             planes: Optional[int] = None,
             offset: Tuple[float, float] = (0.0, 0.0),
             origin: Tuple[int, int] = (0, 0),
             pitch: Optional[int] = None,
             nudge: bool = False) -> torch.Tensor:
    """``out[q, r, c] = Σ_e val_e · hat(x_e + offset_0 − (r + origin_0)) ·
    hat(y_e + offset_1 − (c + origin_1))`` over the events of plane ``q``.

    Args:
        x, y: ``[n]`` row and column coordinates (float).
        values: optional ``[n]`` per-event weights.
        image_size: the output box ``(h, w)``.
        valid: optional ``[n]`` bool mask; invalid events vote nothing.
        sign: optional ``[n]`` polarity; the vote is multiplied by +1 where
            ``sign > 0`` and by −1 elsewhere.
        polarity_planes: optional ``[n]`` polarity instead; plane 0 takes
            ``p > 0``, plane 1 ``p <= 0`` (two planes).
        scale: a scalar weight; ``val_e = valid_e · sign_e · scale ·
            values_e``.
        plane: optional ``[n]`` integer plane index, ``planes`` planes.
        offset: added to the coordinates in float32 (the padding).
        origin: subtracted from the integer corner (the box's corner in
            the frame: voting a box equals cropping the frame's vote).
        pitch: the row stride of the result's storage (``w`` by default);
            the storage columns from ``w`` on hold 0.
        nudge: corners from ``floor(x + offset + 1e-6)``, as the scatter
            of ``ops/iwe.py::bilinear_vote`` takes them.

    Returns ``[h, w]`` when ``planes`` is None and no polarity planes are
    asked for, else ``[P, h, w]``: a view of a ``[P, h, pitch]`` buffer
    when ``pitch > w``.  A CUDA tensor launches the kernel on the current
    stream (float32 result); a CPU tensor runs :func:`hat_vote_plain`.
    """
    h, w, pitch, n_planes = _arguments(x, y, values, image_size, valid,
                                       sign, polarity_planes, plane, planes,
                                       origin, pitch)
    if x.device.type == "cpu":
        return hat_vote_plain(x, y, values, image_size, valid=valid,
                              sign=sign, polarity_planes=polarity_planes,
                              scale=scale, plane=plane, planes=planes,
                              offset=offset, origin=origin, pitch=pitch,
                              nudge=nudge)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    xx, yy = (t.to(torch.float32).contiguous() for t in (x, y))
    ww = None if values is None else values.to(torch.float32).contiguous()
    vv = (None if valid is None
          else valid.to(torch.bool).contiguous().view(torch.uint8))
    pol = sign if sign is not None else polarity_planes
    if pol is not None:
        # sign() keeps p > 0, p <= 0 and NaN apart in any float type
        pol = (pol.contiguous() if pol.dtype == torch.float32
               else torch.sign(pol).to(torch.float32))
    p_mode = 1 if sign is not None else 2 if pol is not None else 0
    pl = None if plane is None else plane.to(torch.int32).contiguous()
    lib = kernels.library()
    with torch.cuda.device(x.device):
        # the kernel zeroes it
        out = torch.empty((n_planes, h, pitch), dtype=torch.float32,
                          device=x.device)
        err = lib.ebt_vote(
            xx.data_ptr(), yy.data_ptr(), _ptr(vv), _ptr(pol), p_mode,
            _ptr(ww), float(scale), _ptr(pl), n_planes, xx.shape[0],
            float(offset[0]), float(offset[1]), int(origin[0]),
            int(origin[1]), int(nudge), h, w, pitch, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hat_vote kernel launch failed (error {err})")
    kernels.launches["hat_vote_image"] += 1
    return _shaped(out, w, 2 if polarity_planes is not None else planes)


def hat_vote_image(x: torch.Tensor, y: torch.Tensor, values: torch.Tensor,
                   image_size: Tuple[int, int]) -> torch.Tensor:
    """``Σ_e values_e · hat(x_e − h) · hat(y_e − w)`` → ``[H, W]`` float32.

    ``x``, ``y``, ``values``: contiguous float32 ``[n]`` tensors on one
    device.  Votes outside ``image_size`` are dropped; ``values == 0``
    disables an event.  A CUDA tensor launches the kernel on the current
    stream; a CPU tensor runs :func:`hat_vote_plain`.
    """
    for name, t in (("x", x), ("y", y), ("values", values)):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    return hat_vote(x, y, values, image_size)


def _event_vote(ev: Events, image_size, weight, padding, **kw):
    """The event record voted in float32 (as the TPU wrappers do), the
    padding added to the coordinates and to the image."""
    ph, pw = padding
    scalar = isinstance(weight, (int, float))
    return hat_vote(ev.x.to(torch.float32), ev.y.to(torch.float32),
                    None if scalar else weight.to(torch.float32),
                    (image_size[0] + 2 * ph, image_size[1] + 2 * pw),
                    valid=ev.valid, scale=float(weight) if scalar else 1.0,
                    offset=(ph, pw), **kw)


def bilinear_vote_cuda(ev: Events, image_size: Tuple[int, int],
                       weight: Union[float, torch.Tensor] = 1.0,
                       padding: Tuple[int, int] = (0, 0),
                       nudge: bool = False) -> torch.Tensor:
    """Drop-in for :func:`event_based_bos_tpu_torch.ops.iwe.bilinear_vote`
    (not differentiable; the floor nudge only with ``nudge``)."""
    return _event_vote(ev, image_size, weight, padding, nudge=nudge)


def signed_vote_cuda(ev: Events, image_size: Tuple[int, int],
                     padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Polarity-signed vote image ``pos − neg`` in one pass (the per-frame
    IWE-cache histogram)."""
    return _event_vote(ev, image_size, 1.0, padding, sign=ev.p)


def polarity_iwe_cuda(ev: Events, image_size: Tuple[int, int],
                      weight: Union[float, torch.Tensor] = 1.0,
                      padding: Tuple[int, int] = (0, 0),
                      nudge: bool = False) -> torch.Tensor:
    """Stacked (positive, negative) vote images ``[2, H, W]``, in one
    launch."""
    return _event_vote(ev, image_size, weight, padding, polarity_planes=ev.p,
                       nudge=nudge)
