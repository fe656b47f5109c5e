"""Statistical helpers: the Gaussian pdf, the Charbonnier loss and SSIM.

PyTorch counterpart of the JAX package's ``ops/stats.py``.  SSIM's
windowed moments are zero-padded 11×11 convolutions (``F.conv2d``), as
the JAX package computes them outside any kernel of its own.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["gaussian_1d", "charbonnier_loss", "ssim"]

SQRT_2PI = math.sqrt(2.0 * math.pi)


def gaussian_1d(mean, std, x):
    """The Gaussian pdf at ``x``."""
    y = (x - mean) ** 2 / (2.0 * std ** 2)
    return torch.exp(-y) / (SQRT_2PI * std)


def charbonnier_loss(delta: torch.Tensor, alpha: float = 0.45,
                     epsilon: float = 1e-3) -> torch.Tensor:
    """The robust Charbonnier loss, ``mean((δ² + ε²)^α)``."""
    return torch.mean((delta ** 2 + epsilon ** 2) ** alpha)


def _ssim_window(window_size: int, sigma: float, dtype, device):
    xs = (torch.arange(window_size, dtype=dtype, device=device)
          - window_size // 2)
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """Structural similarity with a ``window_size``² σ = 1.5 Gaussian
    window: zero-padded ("same") windowed moments, C1 = 0.01², C2 = 0.03².

    Args:
        img1, img2: ``[(b, c,) H, W]``.

    Returns the mean over everything, or with ``size_average=False`` one
    mean a batch item.
    """
    while img1.dim() < 4:
        img1 = img1[None]
        img2 = img2[None]
    b, c, h, w = img1.shape
    win = _ssim_window(window_size, 1.5, img1.dtype, img1.device)[None, None]
    pad = window_size // 2

    def conv(x):
        return F.conv2d(x.reshape(b * c, 1, h, w), win,
                        padding=pad).reshape(b, c, h, w)

    mu1 = conv(img1)
    mu2 = conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = conv(img1 * img1) - mu1_sq
    s2 = conv(img2 * img2) - mu2_sq
    s12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))
