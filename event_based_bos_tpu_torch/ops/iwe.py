"""Event → image conversion: Gaussian blur and the bilinear vote.

PyTorch counterpart of the JAX package's ``ops/iwe.py``.  The vote here is
the plain torch scatter (``index_add``), differentiable with respect to
the coordinates and weights; the per-frame signed vote of the IWE cache
runs on the hand-written CUDA kernel of
:mod:`event_based_bos_tpu_torch.ops.iwe_cuda` instead.  The high-level
images (:func:`create_image_from_events`, :func:`create_iwe`,
:func:`create_eventmask`) vote through that kernel for CUDA tensors (not
differentiable there) and through the scatter for CPU tensors.

Coordinate convention (reference parity): ``x`` is the row / height
coordinate, ``y`` is the column / width coordinate.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..types import Events
from .iwe_cuda import bilinear_vote_cuda, polarity_iwe_cuda

__all__ = ["gaussian_kernel1d", "blur_operators", "cached_blur_operators",
           "gaussian_blur", "bilinear_vote", "count_image",
           "create_image_from_events", "create_iwe", "create_polarity_iwe",
           "create_eventmask"]

_EPS = 1e-6  # floor nudge of the scatter (the reference's torch path)


def _radius(sigma: float, ksize: Optional[int]) -> int:
    """Tap radius: ``round(4σ)`` (cv2 / scipy truncate=4) unless given."""
    if ksize is None:
        return max(int(round(4.0 * float(sigma))), 1)
    return (ksize - 1) // 2


def gaussian_kernel1d(sigma: float, ksize: Optional[int] = None,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> torch.Tensor:
    """Normalized 1-D Gaussian taps (radius ``round(4σ)`` by default)."""
    r = _radius(sigma, ksize)
    xs = torch.arange(-r, r + 1, dtype=dtype, device=resolve_device(device))
    k = torch.exp(-(xs ** 2) / (2.0 * float(sigma) ** 2))
    return k / k.sum()


@functools.lru_cache(maxsize=None)
def _blur_matrix_np(n: int, sigma: float, ksize: Optional[int], mode: str):
    """Dense ``[n, n]`` 1-D Gaussian blur operator with the border folding
    baked in (``mode`` is a ``np.pad`` mode)."""
    r = _radius(sigma, ksize)
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(xs ** 2) / (2.0 * float(sigma) ** 2))
    k /= k.sum()
    eye = np.pad(np.eye(n), ((r, r), (0, 0)), mode=mode)
    m = np.zeros((n, n))
    for j, kj in enumerate(k):
        m += kj * eye[j:j + n, :]
    return m


def blur_operators(shape: Tuple[int, int], sigma: float,
                   ksize: Optional[int] = None, mode: str = "symmetric",
                   dtype: torch.dtype = torch.float32, device=None):
    """The two operators ``(mh, mw)`` of :func:`gaussian_blur` for images
    of trailing shape ``shape``.  Each build copies from the host: a loop
    that blurs every step builds them once and passes them on."""
    return tuple(torch.as_tensor(_blur_matrix_np(n, float(sigma), ksize,
                                                 mode))
                 .to(device=device, dtype=dtype) for n in shape)


@functools.lru_cache(maxsize=16)
def cached_blur_operators(shape, sigma, mode, dtype, device, ksize=None):
    """:func:`blur_operators`, built once per shape, σ, mode, dtype, device
    and size (a build copies from the host): the same matrices, so the
    same numbers."""
    return blur_operators(shape, sigma, ksize, mode=mode, dtype=dtype,
                          device=device)


def gaussian_blur(image: torch.Tensor, sigma: float,
                  ksize: Optional[int] = None,
                  mode: str = "symmetric", operators=None) -> torch.Tensor:
    """Separable Gaussian blur over the trailing two axes, as two matmuls
    with border-folded blur operators.

    ``mode`` is a ``np.pad`` mode: ``"symmetric"`` repeats the edge (scipy
    ``reflect``), ``"reflect"`` is reflect-101 (cv2's default border).
    ``operators`` is :func:`blur_operators`' result for the same shape,
    sigma, size and mode.
    """
    if sigma is None or float(sigma) <= 0:
        return image
    mh, mw = operators or blur_operators(image.shape[-2:], sigma, ksize,
                                         mode, image.dtype, image.device)
    return torch.matmul(torch.matmul(mh, image), mw.T)


def _corner_data(ev: Events, image_size, padding, weight):
    """Corner indices/weights of the scatter: floor with an epsilon nudge,
    4-neighbour indices, per-corner in-bounds masks."""
    ph, pw = padding
    h = image_size[0] + 2 * ph
    w = image_size[1] + 2 * pw
    fx = torch.floor(ev.x + _EPS)
    fy = torch.floor(ev.y + _EPS)
    dx = ev.x - fx
    dy = ev.y - fy
    # clamping (after the padding shift) keeps the int cast defined and
    # leaves every in-bounds corner where it was
    r0 = (fx + ph).clamp(-2, h).to(torch.int64)
    c0 = (fy + pw).clamp(-2, w).to(torch.int64)
    base = torch.where(ev.valid, torch.ones_like(ev.x), 0.0) * weight
    corners = []
    for dr, dc, wgt in ((0, 0, (1 - dx) * (1 - dy)),
                        (1, 0, dx * (1 - dy)),
                        (0, 1, (1 - dx) * dy),
                        (1, 1, dx * dy)):
        r = r0 + dr
        c = c0 + dc
        inb = (r >= 0) & (r < h) & (c >= 0) & (c < w)
        idx = torch.where(inb, r * w + c, 0)
        corners.append((idx, wgt, inb))
    return (h, w), base, corners


def bilinear_vote(ev: Events, image_size: Tuple[int, int],
                  weight: Union[float, torch.Tensor] = 1.0,
                  padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Accumulate bilinear votes of events into an ``[H+2ph, W+2pw]`` image.

    ``weight`` is a scalar or a per-event ``[n]`` tensor.  Corners outside
    the (padded) frame are dropped.
    """
    (h, w), base, corners = _corner_data(ev, image_size, padding, weight)
    flat = torch.zeros((h * w,), dtype=base.dtype, device=base.device)
    for idx, wgt, inb in corners:
        flat = flat.index_add(0, idx, torch.where(inb, wgt * base, 0.0))
    return flat.reshape(h, w)


def create_polarity_iwe(ev: Events, image_size: Tuple[int, int],
                        weight: Union[float, torch.Tensor] = 1.0,
                        padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Stacked (positive, negative) vote images, ``[2, H, W]``."""
    pos = bilinear_vote(ev.mask_where(ev.p > 0), image_size, weight, padding)
    neg = bilinear_vote(ev.mask_where(ev.p <= 0), image_size, weight, padding)
    return torch.stack([pos, neg], dim=0)


def count_image(ev: Events, image_size: Tuple[int, int],
                padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Event count image: every live event adds 1 at each of its in-bounds
    corner pixels (the reference's count, four unit votes an event)."""
    (h, w), base, corners = _corner_data(ev, image_size, padding, 1.0)
    flat = torch.zeros((h * w,), dtype=base.dtype, device=base.device)
    for idx, _wgt, inb in corners:
        flat = flat.index_add(0, idx, torch.where(inb, base, 0.0))
    return flat.reshape(h, w)


def create_image_from_events(ev: Events, image_size: Tuple[int, int],
                             method: str = "bilinear_vote",
                             weight: Union[float, torch.Tensor] = 1.0,
                             sigma: float = 0,
                             padding: Tuple[int, int] = (0, 0),
                             blur_ksize: Optional[int] = None
                             ) -> torch.Tensor:
    """An image of the events by ``method`` (``count``, ``bilinear_vote``
    or ``polarity``), blurred with ``sigma`` (scipy-style border).

    For CUDA tensors ``bilinear_vote`` and ``polarity`` are one launch of
    the vote kernel with the scatter's floor nudge (float32, not
    differentiable); for CPU tensors they are the scatter.
    """
    cuda = ev.x.device.type == "cuda"
    if method == "count":
        image = count_image(ev, image_size, padding)
    elif method == "bilinear_vote":
        image = (bilinear_vote_cuda(ev, image_size, weight, padding,
                                    nudge=True) if cuda
                 else bilinear_vote(ev, image_size, weight, padding))
    elif method == "polarity":
        image = (polarity_iwe_cuda(ev, image_size, weight, padding,
                                   nudge=True) if cuda
                 else create_polarity_iwe(ev, image_size, weight, padding))
    else:
        raise NotImplementedError(f"method = {method!r} is not supported.")
    if sigma and sigma > 0:
        image = gaussian_blur(image, sigma, ksize=blur_ksize,
                              operators=cached_blur_operators(
                                  tuple(image.shape[-2:]), float(sigma),
                                  "symmetric", image.dtype, image.device,
                                  blur_ksize))
    return image


def create_iwe(ev: Events, image_size: Tuple[int, int],
               method: str = "bilinear_vote", sigma: float = 1,
               padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Image of warped events: :func:`create_image_from_events` with unit
    weights, blurred with ``sigma``."""
    return create_image_from_events(ev, image_size, method, 1.0, sigma,
                                    padding)


def create_eventmask(ev: Events, image_size: Tuple[int, int],
                     padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``[1, H, W]`` bool mask of the pixels that receive any vote."""
    im = create_image_from_events(ev, image_size, "bilinear_vote", 1.0, 0,
                                  padding)
    return (im != 0)[None]
