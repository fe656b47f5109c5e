"""Dense image warping and resize.

PyTorch counterpart of the JAX package's ``ops/image_warp.py``:

  * :func:`warp_image_stencil` — the gather-free pattern-shift warp of the
    solve loop (sign-select 4-tap form at radius 1, hat sum for R > 1);
  * :func:`sample_bilinear` / :func:`warp_image_forward` — the gather warp
    (``grid_sample`` semantics, zeros outside), the radius-0 path;
  * :func:`shift_image_matrix` / :func:`warp_image_shift` — a global
    bilinear shift, as two banded matmuls or as a gather;
  * :func:`resize_bilinear` — half-pixel bilinear resize as two matmuls
    with interpolation matrices built in numpy;
  * :func:`standardize_image_minmax`, :func:`standardize_image_center` and
    :func:`range_norm` — the display normalisations of the visualizer.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import abs_

__all__ = ["sample_bilinear", "warp_image_forward", "warp_image_stencil",
           "shift_image_matrix", "warp_image_shift", "resize_matrix",
           "resize_bilinear", "standardize_image_minmax",
           "standardize_image_center", "range_norm"]


def sample_bilinear(image: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``image[rows, cols]`` with zeros outside the frame
    (``grid_sample(align_corners=True, padding_mode='zeros')``)."""
    h, w = image.shape[-2:]
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    dr = rows - r0
    dc = cols - c0
    out = None
    for rr, cc, wgt in ((r0, c0, (1 - dr) * (1 - dc)),
                        (r0 + 1, c0, dr * (1 - dc)),
                        (r0, c0 + 1, (1 - dr) * dc),
                        (r0 + 1, c0 + 1, dr * dc)):
        inb = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
        ri = rr.clamp(0, h - 1).to(torch.int64)
        ci = cc.clamp(0, w - 1).to(torch.int64)
        term = torch.where(inb, image[..., ri, ci] * wgt, 0.0)
        out = term if out is None else out + term
    return out


def warp_image_forward(image: torch.Tensor, flow: torch.Tensor
                       ) -> torch.Tensor:
    """``out[x, y] = image[x − fx, y − fy]`` for a ``[2, H, W]`` flow."""
    h, w = image.shape[-2:]
    gr, gc = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    return sample_bilinear(image, gr - flow[0], gc - flow[1])


def _shift2(img: torch.Tensor, orow: int, ocol: int) -> torch.Tensor:
    """``out[r, c] = img[r + orow, c + ocol]``, zero outside the frame."""
    if orow > 0:
        img = F.pad(img[..., orow:, :], (0, 0, 0, orow))
    elif orow < 0:
        img = F.pad(img[..., :orow, :], (0, 0, -orow, 0))
    if ocol > 0:
        img = F.pad(img[..., :, ocol:], (0, ocol))
    elif ocol < 0:
        img = F.pad(img[..., :, :ocol], (-ocol, 0))
    return img


def warp_image_stencil(image: torch.Tensor, flow: torch.Tensor,
                       radius: int = 1) -> torch.Tensor:
    """Gather-free bilinear warp for bounded displacements.

    Equal to :func:`warp_image_forward` where ``|flow| <= radius``: the
    sample at ``(r − u, c − v)`` is the ``(2R+1)²``-point stencil
    ``Σ_o hat(u + o_r)·hat(v + o_c)·image(r + o_r, c + o_c)``, zero outside
    the frame.  At radius 1 the sign-select 4-tap form is used, which
    extrapolates linearly beyond ``|flow| = 1`` instead of fading (the
    solver's accuracy depends on that; it is not ``grid_sample``).

    Args:
        image: ``[..., H, W]``; leading axes share the flow.
        flow: ``[2, H, W]`` (row, col) displacement, or ``[2]`` global shift.
    """
    h, w = image.shape[-2:]
    if flow.dim() == 1:
        u = flow[0].expand(h, w)
        v = flow[1].expand(h, w)
    else:
        u, v = flow[0], flow[1]

    if radius == 1 and flow.dim() != 1:
        au = abs_(u)
        av = abs_(v)
        up = u >= 0
        vp = v >= 0
        i_su = torch.where(up, _shift2(image, -1, 0), _shift2(image, 1, 0))
        i_sv = torch.where(vp, _shift2(image, 0, -1), _shift2(image, 0, 1))
        i_suv = torch.where(
            up,
            torch.where(vp, _shift2(image, -1, -1), _shift2(image, -1, 1)),
            torch.where(vp, _shift2(image, 1, -1), _shift2(image, 1, 1)))
        return ((1 - au) * (1 - av) * image + (1 - au) * av * i_sv
                + au * (1 - av) * i_su + au * av * i_suv)

    zero = u.new_zeros(())  # maximum() splits a tie's gradient, as in JAX
    out = torch.zeros_like(image)
    for orow in range(-radius, radius + 1):
        wr = torch.maximum(1.0 - abs_(u + orow), zero)
        for ocol in range(-radius, radius + 1):
            wc = torch.maximum(1.0 - abs_(v + ocol), zero)
            out = out + wr * wc * _shift2(image, orow, ocol)
    return out


def shift_image_matrix(image: torch.Tensor, shift: torch.Tensor
                       ) -> torch.Tensor:
    """Global bilinear shift ``out(x) = image(x − shift)``, zero outside, as
    two banded matmuls with ``M[i, j] = hat(j − i + shift)`` — exact for a
    shift of any size and differentiable with respect to it.

    Args:
        image: ``[..., H, W]``.
        shift: ``[2]`` (row, col), or ``[..., 2]`` with one shift per
            leading index of ``image``.
    """
    h, w = image.shape[-2:]
    zero = image.new_zeros(())

    def band(n, s):
        ii = torch.arange(n, dtype=image.dtype, device=image.device)
        d = ii[None, :] - ii[:, None] + s[..., None, None]
        return torch.maximum(1.0 - abs_(d), zero)

    mr = band(h, shift[..., 0])
    mc = band(w, shift[..., 1])
    return torch.matmul(torch.matmul(mr, image), mc.transpose(-1, -2))


def warp_image_shift(image: torch.Tensor, shift: torch.Tensor
                     ) -> torch.Tensor:
    """Warp by a global ``[2]`` translation through the bilinear gather."""
    h, w = image.shape[-2:]
    gr, gc = torch.meshgrid(
        torch.arange(h, dtype=image.dtype, device=image.device),
        torch.arange(w, dtype=image.dtype, device=image.device),
        indexing="ij")
    return sample_bilinear(image, gr - shift[0], gc - shift[1])


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """Dense ``[out, in]`` bilinear interpolation matrix (half-pixel
    centers, ``interpolate(mode='bilinear', align_corners=False)``)."""
    m = np.zeros((out_size, in_size), np.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    m[np.arange(out_size), lo] += 1.0 - frac
    m[np.arange(out_size), hi] += frac
    return m


def resize_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                  device) -> torch.Tensor:
    return torch.as_tensor(_resize_matrix_np(in_size, out_size)).to(
        device=device, dtype=dtype)


def resize_bilinear(image: torch.Tensor, out_shape: Tuple[int, int]
                    ) -> torch.Tensor:
    """Bilinear resize of the trailing 2 axes via two matmuls."""
    h, w = image.shape[-2:]
    oh, ow = out_shape
    if (h, w) == (oh, ow):
        return image
    mh = resize_matrix(h, oh, image.dtype, image.device)
    mw = resize_matrix(w, ow, image.dtype, image.device)
    return torch.matmul(torch.matmul(mh, image), mw.T)


def standardize_image_minmax(array: torch.Tensor, new_min: float = 0.0,
                             new_max: float = 255.0) -> torch.Tensor:
    """Min-max standardization onto ``[new_min, new_max]``."""
    st = (array - array.min()) / (array.max() - array.min())
    return st * (new_max - new_min) + new_min


def standardize_image_center(array: torch.Tensor, old_center: float = 0.0,
                             new_center: float = 128.0,
                             new_max: float = 255.0) -> torch.Tensor:
    """Center-preserving standardization: ``old_center`` maps to
    ``new_center`` and the largest magnitude to ``new_max`` (a NaN
    propagates, as in ``jnp.maximum``)."""
    max_abs = torch.clamp(torch.abs(array).max(), min=1e-12)
    return ((array - old_center) / max_abs * (new_max - new_center)
            + new_center)


def range_norm(array: torch.Tensor, lower=None, upper=None,
               new_max: float = 255.0) -> torch.Tensor:
    """Clip to ``[lower, upper]`` (the array's own range by default), then
    scale onto ``[0, new_max]``."""
    lower = array.min() if lower is None else lower
    upper = array.max() if upper is None else upper
    clipped = torch.minimum(
        torch.maximum(array, torch.as_tensor(lower, dtype=array.dtype,
                                             device=array.device)),
        torch.as_tensor(upper, dtype=array.dtype, device=array.device))
    return (clipped - lower) / (upper - lower + 1e-12) * new_max
