"""Poisson integration of gradient fields through the DST-II, as matmuls.

PyTorch counterpart of the JAX package's ``ops/poisson.py``: the discrete
sine transforms are dense basis-matrix products (``dh @ rhs @ dw.T`` and
back), which match ``scipy.fftpack.dst(norm='ortho')``.  The matrices are
built in float64 numpy and cached per (size, dtype, device), so no frame
pays an upload.  On the card the products must run in full float32:
TF32 matmuls (off by default in PyTorch) would round the spectrum.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .image_warp import standardize_image_center

__all__ = ["dst2_matrix", "poisson_reconstruct", "poisson_integrate_flow",
           "poisson_view"]


@functools.lru_cache(maxsize=None)
def _dst2_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DST-II matrix ``D`` with ``dst(x) = D @ x``
    (``scipy.fftpack.dst(x, type=2, norm='ortho')``):
    ``X_k = f_k · 2 Σ_n x_n sin(π (k+1)(2n+1) / (2N))`` with
    ``f_k = √(1/(4N))`` for ``k = N−1`` else ``√(1/(2N))``; ``D⁻¹ = Dᵀ``.
    """
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    d = 2.0 * np.sin(np.pi * (k + 1) * (2 * m + 1) / (2 * n))
    f = np.full((n, 1), np.sqrt(1.0 / (2 * n)))
    f[n - 1] = np.sqrt(1.0 / (4 * n))
    return (f * d).astype(np.float64)


@functools.lru_cache(maxsize=16)
def _cached_dst2(n: int, dtype: torch.dtype, device: torch.device
                 ) -> torch.Tensor:
    return torch.as_tensor(_dst2_matrix_np(n)).to(device=device, dtype=dtype)


def dst2_matrix(n: int, dtype: torch.dtype = torch.float32,
                device="cpu") -> torch.Tensor:
    """The ``[n, n]`` DST-II matrix on ``device`` in ``dtype``, built once
    per (n, dtype, device); callers must not write into it."""
    return _cached_dst2(int(n), dtype, torch.device(device))


def poisson_reconstruct(grady: torch.Tensor, gradx: torch.Tensor,
                        boundary: torch.Tensor) -> torch.Tensor:
    """Integrate a gradient field into an intensity image (Dirichlet
    boundary): the divergence from one-sided differences of ``(grady,
    gradx)``, less the boundary's contribution, solved for the 5-point
    Laplacian in the DST-II basis, with the boundary put back.

    Args:
        grady: ``[H, W]`` gradient along rows.
        gradx: ``[H, W]`` gradient along columns.
        boundary: ``[H, W]`` boundary image; its dtype and device are the
            computation's.
    """
    dtype, dev = boundary.dtype, boundary.device
    gyy = (grady[1:, :-1] - grady[:-1, :-1]).to(dtype)
    gxx = (gradx[:-1, 1:] - gradx[:-1, :-1]).to(dtype)
    f = torch.zeros(boundary.shape, dtype=dtype, device=dev)
    f[:-1, 1:] += gxx
    f[1:, :-1] += gyy

    b_only = boundary.clone()
    b_only[1:-1, 1:-1] = 0
    f_bp = (-4 * b_only[1:-1, 1:-1] + b_only[1:-1, 2:] + b_only[1:-1, :-2]
            + b_only[2:, 1:-1] + b_only[:-2, 1:-1])
    rhs = f[1:-1, 1:-1] - f_bp

    h, w = rhs.shape
    dh = dst2_matrix(h, dtype, dev)
    dw = dst2_matrix(w, dtype, dev)
    # 2-D DST-II: rows then columns (ortho, so the order is immaterial)
    spec = dh @ rhs @ dw.T
    xk = torch.arange(1, w + 1, dtype=dtype, device=dev)
    yk = torch.arange(1, h + 1, dtype=dtype, device=dev)
    denom = ((2 * torch.cos(math.pi * xk / (w + 2)) - 2)[None, :]
             + (2 * torch.cos(math.pi * yk / (h + 2)) - 2)[:, None])
    spec = spec / denom
    out = b_only
    out[1:-1, 1:-1] = dh.T @ spec @ dw
    return out


def poisson_integrate_flow(flow: torch.Tensor) -> torch.Tensor:
    """Integrate a ``[2, H, W]`` flow into a scalar potential image: the
    reconstruction from ``(flow[1], flow[0])`` with a zero boundary."""
    return poisson_reconstruct(flow[1], flow[0], torch.zeros_like(flow[0]))


def poisson_view(flow: torch.Tensor) -> torch.Tensor:
    """The uint8 Poisson view of a ``[2, H, W]`` flow: the float32
    integral, center-standardized into ``[1, 255]`` and truncated."""
    p = poisson_integrate_flow(flow.to(torch.float32))
    return standardize_image_center(p).to(torch.uint8)
