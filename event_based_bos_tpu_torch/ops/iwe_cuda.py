"""The bilinear event vote on the hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/iwe_pallas.py``: the same four entry
points (``hat_vote_image`` and the ``bilinear``/``signed``/``polarity``
wrappers) with the same ``_prepared`` semantics — invalid slots get weight
0 and coordinates −2, the polarity sign is folded into the weight, and
``padding`` shifts the coordinates and grows the image.

:func:`hat_vote_image` launches ``csrc/hat_vote.cu`` for a CUDA tensor and
raises if it cannot; for a CPU tensor it runs :func:`hat_vote_plain`, the
torch scatter that repeats the kernel's arithmetic (exact hat weights
from ``floor(x)``, no epsilon nudge).  Integer coordinates give bit-equal
images on both; fractional ones agree to f32 summation order.  Not
differentiable — events enter the solver only through this per-frame
constant.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .. import kernels
from ..types import Events

__all__ = ["hat_vote_image", "hat_vote_plain", "bilinear_vote_cuda",
           "signed_vote_cuda", "polarity_iwe_cuda"]


def hat_vote_plain(x: torch.Tensor, y: torch.Tensor, values: torch.Tensor,
                   image_size: Tuple[int, int]) -> torch.Tensor:
    """``Σ_e values_e · hat(x_e − h) · hat(y_e − w)`` as a torch scatter —
    the plain version of the CUDA kernel, with the kernel's arithmetic."""
    h, w = image_size
    fx = torch.floor(x)
    fy = torch.floor(y)
    dx = x - fx
    dy = y - fy
    r0 = fx.clamp(-2, h).to(torch.int64)
    c0 = fy.clamp(-2, w).to(torch.int64)
    flat = torch.zeros((h * w,), dtype=torch.float32, device=x.device)
    for a, wr in ((0, 1 - dx), (1, dx)):
        for b, wc in ((0, 1 - dy), (1, dy)):
            r = r0 + a
            c = c0 + b
            inb = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            idx = torch.where(inb, r * w + c, 0)
            flat.index_add_(0, idx, torch.where(inb, wr * wc * values, 0.0))
    return flat.reshape(h, w)


def hat_vote_image(x: torch.Tensor, y: torch.Tensor, values: torch.Tensor,
                   image_size: Tuple[int, int]) -> torch.Tensor:
    """``Σ_e values_e · hat(x_e − h) · hat(y_e − w)`` → ``[H, W]`` float32.

    ``x``, ``y``, ``values``: contiguous float32 ``[n]`` tensors on one
    device.  Votes outside ``image_size`` are dropped; ``values == 0``
    disables an event.  A CUDA tensor launches the kernel on the current
    stream; a CPU tensor runs :func:`hat_vote_plain`.
    """
    h, w = (int(s) for s in image_size)
    for name, t in (("x", x), ("y", y), ("values", values)):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device or t.shape != x.shape:
            raise ValueError(f"{name} must match x in device and length")
    if h <= 0 or w <= 0:
        raise ValueError(f"image_size must be positive, got {image_size}")
    if x.device.type == "cpu":
        return hat_vote_plain(x, y, values, (h, w))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = kernels.library()
    with torch.cuda.device(x.device):
        out = torch.zeros((h, w), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ebt_hat_vote(x.data_ptr(), y.data_ptr(), values.data_ptr(),
                               x.shape[0], h, w, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hat_vote kernel launch failed (cudaError {err})")
    kernels.launches["hat_vote_image"] += 1
    return out


def _prepared(ev: Events, weight: Union[float, torch.Tensor], sign: bool):
    """Coordinates parked at −2 where invalid, weights masked (and signed)."""
    val = torch.where(ev.valid, torch.ones_like(ev.x), 0.0)
    if sign:
        val = val * torch.where(ev.p > 0, 1.0, -1.0)
    if isinstance(weight, (int, float)):
        val = val * float(weight)
    else:
        val = val * weight.to(val.dtype)
    x = torch.where(ev.valid, ev.x, -2.0).to(torch.float32)
    y = torch.where(ev.valid, ev.y, -2.0).to(torch.float32)
    return x.contiguous(), y.contiguous(), val.to(torch.float32).contiguous()


def _vote(ev, image_size, weight, padding, sign):
    ph, pw = padding
    x, y, val = _prepared(ev, weight, sign)
    return hat_vote_image(x + ph, y + pw, val,
                          (image_size[0] + 2 * ph, image_size[1] + 2 * pw))


def bilinear_vote_cuda(ev: Events, image_size: Tuple[int, int],
                       weight: Union[float, torch.Tensor] = 1.0,
                       padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Drop-in for :func:`event_based_bos_tpu_torch.ops.iwe.bilinear_vote`
    (not differentiable)."""
    return _vote(ev, image_size, weight, padding, sign=False)


def signed_vote_cuda(ev: Events, image_size: Tuple[int, int],
                     padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Polarity-signed vote image ``pos − neg`` in one pass (the per-frame
    IWE-cache histogram)."""
    return _vote(ev, image_size, 1.0, padding, sign=True)


def polarity_iwe_cuda(ev: Events, image_size: Tuple[int, int],
                      weight: Union[float, torch.Tensor] = 1.0,
                      padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Stacked (positive, negative) vote images ``[2, H, W]``."""
    pos = bilinear_vote_cuda(ev.mask_where(ev.p > 0), image_size, weight,
                             padding)
    neg = bilinear_vote_cuda(ev.mask_where(ev.p <= 0), image_size, weight,
                             padding)
    return torch.stack([pos, neg], dim=0)
