"""Image-gradient kernels: Sobel on frames and on the Poisson potential.

PyTorch counterpart of the JAX package's ``ops/gradients.py``.  The Sobel
is written as shifted adds of an explicitly padded image rather than a
convolution: a float32 convolution goes through cuDNN in TF32 by default,
which would cut the Poisson-potential flow to about three digits.  The
padding is built from slices and ``cat``, whose backward is deterministic
(``F.pad``'s replicate and reflect backward scatter with atomics).

Convention: "x" is the row / height direction throughout (reference
parity).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import resolve_device

__all__ = ["sobel_kernels", "sobel_xy", "frame_gradients", "poisson_to_flow",
           "central_gradient", "sobel_divergence", "strain_variant"]

_SOBEL_X = {
    3: [[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]],
    5: [[-2, -2, -4, -2, -2], [-1, -1, -2, -1, -1], [0, 0, 0, 0, 0],
        [1, 1, 2, 1, 1], [2, 2, 4, 2, 2]],
}


def sobel_kernels(ksize: int = 3, dtype: torch.dtype = torch.float32,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Gx, Gy) Sobel taps; Gx differentiates along rows (height)."""
    if ksize not in _SOBEL_X:
        raise ValueError("ksize must be 3 or 5")
    gx = torch.tensor(_SOBEL_X[ksize], dtype=dtype,
                      device=resolve_device(device))
    return gx, gx.T


def _pad_axis(x: torch.Tensor, r: int, dim: int, mode: str) -> torch.Tensor:
    """``np.pad`` of one axis by ``r``: ``"edge"`` repeats the border,
    ``"reflect"`` mirrors without repeating it (reflect-101)."""
    n = x.shape[dim]
    if mode == "edge":
        lo = [x.narrow(dim, 0, 1)] * r
        hi = [x.narrow(dim, n - 1, 1)] * r
    elif mode == "reflect":
        lo = [x.narrow(dim, 1, r).flip(dim)]
        hi = [x.narrow(dim, n - 1 - r, r).flip(dim)]
    else:
        raise ValueError(f"unsupported pad mode {mode!r}")
    return torch.cat(lo + [x] + hi, dim=dim)


def _conv2d_same(image: torch.Tensor, taps, pad_mode: str) -> torch.Tensor:
    """Cross-correlation with explicit padding; image ``[..., H, W]``,
    ``taps`` a nested list of Python numbers (zero taps are skipped)."""
    r = (len(taps) - 1) // 2
    h, w = image.shape[-2:]
    img = _pad_axis(_pad_axis(image, r, -2, pad_mode), r, -1, pad_mode)
    out = None
    for i, row in enumerate(taps):
        for j, k in enumerate(row):
            if k == 0:
                continue
            term = img[..., i:i + h, j:j + w] * float(k)
            out = term if out is None else out + term
    return out


def sobel_xy(image: torch.Tensor, ksize: int = 3, pad_mode: str = "edge"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d/drow, d/dcol) Sobel responses; ``pad_mode`` is ``"edge"``
    (replicate) or ``"reflect"`` (reflect-101, cv2's default)."""
    if ksize not in _SOBEL_X:
        raise ValueError("ksize must be 3 or 5")
    gx = _SOBEL_X[ksize]
    gy = [list(col) for col in zip(*gx)]
    return _conv2d_same(image, gx, pad_mode), _conv2d_same(image, gy, pad_mode)


def frame_gradients(frame: torch.Tensor, ksize: int = 3,
                    use_log_intensity: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-intensity gradients feeding the generative model: optional
    ``log(I + 1)``, then Sobel with the reflect-101 border."""
    if use_log_intensity:
        frame = torch.log(frame + 1.0)
    return sobel_xy(frame, ksize=ksize, pad_mode="reflect")


def poisson_to_flow(intensity: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Flow ``[..., 2, H, W]`` from a scalar potential ``[..., H, W]``:
    Sobel with the replicate border, divided by 8."""
    dx, dy = sobel_xy(intensity, ksize=ksize, pad_mode="edge")
    return torch.stack([dx, dy], dim=-3) / 8.0


def sobel_divergence(flow: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Divergence ``(du/dx + dv/dy) / 8`` of a flow ``[..., 2, H, W]``:
    Sobel with the replicate border."""
    dxx, _ = sobel_xy(flow[..., 0, :, :], ksize, "edge")
    _, dyy = sobel_xy(flow[..., 1, :, :], ksize, "edge")
    return (dxx + dyy) / 8.0


def central_gradient(image: torch.Tensor, axis: int) -> torch.Tensor:
    """Second-order central differences, one-sided at the edges
    (``torch.gradient`` / ``np.gradient`` with unit spacing)."""
    n = image.shape[axis]
    interior = (image.narrow(axis, 2, n - 2)
                - image.narrow(axis, 0, n - 2)) / 2.0
    first = image.narrow(axis, 1, 1) - image.narrow(axis, 0, 1)
    last = image.narrow(axis, n - 1, 1) - image.narrow(axis, n - 2, 1)
    return torch.cat([first, interior, last], dim=axis)


def strain_variant(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Strain magnitude variant of the flow components ``u``, ``v``:
    Sobel/8 with the reflect-101 border."""
    du_dx, du_dy = (g / 8.0 for g in sobel_xy(u, 3, "reflect"))
    dv_dx, dv_dy = (g / 8.0 for g in sobel_xy(v, 3, "reflect"))
    return du_dx**2 + dv_dy**2 + 0.5 * (du_dy + dv_dx) ** 2
