"""Plain PyTorch pieces shared by the references: the event vote, the
Gaussian blur, the patch-grid interpolation, the Sobel taps, the JAX
derivative rule of ``|x|`` and Adam.

Written from the published description of each operation (and the JAX
package's conventions, which the port follows), with no import of the port:
the references must hold the port to these semantics, not to its own code.
Everything runs in the dtype of its inputs; the references use float64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

FLOOR_NUDGE = 1e-6   # the vote floors x + 1e-6 (the reference scatter's rule)


def solver_dtype(config: dict) -> torch.dtype:
    """The dtype the configuration states (``precision``, 32 by
    default)."""
    return (torch.float64 if str(config["solver"].get("precision", "32"))
            == "64" else torch.float32)


def schedule(config: dict):
    """Adam steps of each scale, coarsest first: ``n_iter // (S − i + 1)``
    over the ``S = log2(coarsest / finest) + 1`` patch sizes, each half the
    one before."""
    pe = config["solver"]["patch_eklt"]
    n_scales = int(np.log2(int(pe["coarsest_patch_size"])
                           // int(pe["finest_patch_size"]))) + 1
    n_iter = int(config["solver"]["optimizer"]["n_iter"])
    return [n_iter // (n_scales - i + 1) for i in range(n_scales)]


def schedule_faults(losses, config: dict) -> int:
    """Scales missing from, or added to, a solve's per-scale loss
    histories, and scales whose history has another length than the
    schedule or a loss that is not finite."""
    want = schedule(config)
    faults = abs(len(losses) - len(want))
    for got, n in zip(losses, want):
        got = np.asarray(got)
        faults += int(got.shape != (n,) or not np.all(np.isfinite(got)))
    return faults


def roi(config: dict):
    """The ROI ``(row0, row1, col0, col1)`` of the configuration."""
    p = config["solver"]["filter"]["parameters"]
    return p["xmin"], p["xmax"], p["ymin"], p["ymax"]


def roi_events(events: np.ndarray, config: dict, dtype,
               device) -> torch.Tensor:
    """The ``(n, 4)`` host array's events inside the ROI (the configured
    filter's crop, applied before anything reads the events) as a
    tensor."""
    x0, x1, y0, y1 = roi(config)
    ev = np.asarray(events)
    keep = ((ev[:, 0] >= x0) & (ev[:, 0] < x1) & (ev[:, 1] >= y0)
            & (ev[:, 1] < y1))
    return torch.as_tensor(ev[keep]).to(device=device, dtype=dtype)


def vote(rows: torch.Tensor, cols: torch.Tensor, values: torch.Tensor,
         shape: Tuple[int, int], planes: int = 1,
         plane: Optional[torch.Tensor] = None,
         origin: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Bilinear vote of events into ``[planes, H, W]``: each event adds
    ``value · (1 − dx)(1 − dy)`` and the other three corner weights to the
    pixels around ``(row − origin_r, col − origin_c)``; corners outside
    the box are dropped."""
    h, w = shape
    r = rows - origin[0]
    c = cols - origin[1]
    fr = torch.floor(r + FLOOR_NUDGE)
    fc = torch.floor(c + FLOOR_NUDGE)
    dr = r - fr
    dc = c - fc
    q = (torch.zeros_like(fr, dtype=torch.int64) if plane is None
         else plane.to(torch.int64))
    out = torch.zeros(planes * h * w, dtype=values.dtype, device=values.device)
    for orow, ocol, wgt in ((0, 0, (1 - dr) * (1 - dc)), (1, 0, dr * (1 - dc)),
                            (0, 1, (1 - dr) * dc), (1, 1, dr * dc)):
        rr = fr.to(torch.int64) + orow
        cc = fc.to(torch.int64) + ocol
        keep = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w) & (q >= 0) & (
            q < planes)
        idx = torch.where(keep, (q * h + rr) * w + cc, 0)
        out.index_add_(0, idx, torch.where(keep, wgt * values, 0.0))
    return out.reshape(planes, h, w)


def blur_matrix(n: int, sigma: float, mode: str) -> np.ndarray:
    """``[n, n]`` Gaussian blur (radius round(4σ), taps normalized) with
    the border folded in: ``mode`` is a ``np.pad`` mode (``"reflect"``
    mirrors without repeating the edge, ``"symmetric"`` repeats it)."""
    r = max(int(round(4.0 * sigma)), 1)
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    k /= k.sum()
    eye = np.pad(np.eye(n), ((r, r), (0, 0)), mode=mode)
    m = np.zeros((n, n))
    for j, kj in enumerate(k):
        m += kj * eye[j:j + n, :]
    return m


def blur(image: torch.Tensor, sigma: float, mode: str) -> torch.Tensor:
    """Separable Gaussian blur of the trailing two axes."""
    h, w = image.shape[-2:]
    mh = torch.as_tensor(blur_matrix(h, sigma, mode)).to(image)
    mw = torch.as_tensor(blur_matrix(w, sigma, mode)).to(image)
    return mh @ image @ mw.T


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` bilinear resize with half-pixel centers (clamped
    at the edges)."""
    m = np.zeros((n_out, n_in))
    if n_in == 1:
        m[:, 0] = 1.0
        return m
    src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0,
                  n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return m


def grid_shape(image_size, patch: int) -> Tuple[int, int]:
    """Rows and columns of square ``patch`` patches at stride ``patch``."""
    return tuple(len(range(0, n - patch + patch, patch)) for n in image_size)


def dense_matrices(image_size, patch: int, rows: np.ndarray,
                   cols: np.ndarray, dtype, device):
    """``(mh, mw_t)`` with ``dense = mh @ field @ mw_t``: the patch grid,
    padded by one patch on each side with its edge values, resized by the
    stride with half-pixel centers, and center-cropped to the image; only
    the image ``rows`` and ``cols`` are kept."""
    out = []
    for n, size, idx in zip(grid_shape(image_size, patch), image_size,
                            (rows, cols)):
        up = (n + 2) * patch
        start = up // 2 - size // 2
        edge = np.zeros((n + 2, n))
        edge[np.arange(n + 2), np.clip(np.arange(-1, n + 1), 0, n - 1)] = 1.0
        out.append(resize_matrix(n + 2, up)[start + np.asarray(idx)] @ edge)
    mh, mw = out
    return (torch.as_tensor(mh).to(device=device, dtype=dtype),
            torch.as_tensor(np.ascontiguousarray(mw.T)).to(device=device,
                                                           dtype=dtype))


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose derivative is +1 at 0 (JAX's rule, which the
    configurations' solvers were written under)."""
    return torch.where(x >= 0, x, -x)


def pad(x: torch.Tensor, r: int, dim: int, mode: str) -> torch.Tensor:
    """``np.pad`` of one axis by ``r``: ``"edge"`` or ``"reflect"``."""
    n = x.shape[dim]
    if mode == "edge":
        lo = [x.narrow(dim, 0, 1)] * r
        hi = [x.narrow(dim, n - 1, 1)] * r
    else:
        lo = [x.narrow(dim, 1, r).flip(dim)]
        hi = [x.narrow(dim, n - 1 - r, r).flip(dim)]
    return torch.cat(lo + [x] + hi, dim=dim)


SOBEL_ROWS = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def sobel(image: torch.Tensor, mode: str):
    """3×3 Sobel responses ``(d/drow, d/dcol)`` of ``[..., H, W]``
    (cross-correlation, border by ``mode``)."""
    h, w = image.shape[-2:]
    p = pad(pad(image, 1, -2, mode), 1, -1, mode)

    def correlate(taps):
        out = 0.0
        for i in range(3):
            for j in range(3):
                if taps[i][j]:
                    out = out + taps[i][j] * p[..., i:i + h, j:j + w]
        return out

    cols_taps = tuple(zip(*SOBEL_ROWS))
    return correlate(SOBEL_ROWS), correlate(cols_taps)


def shift(img: torch.Tensor, orow: int, ocol: int) -> torch.Tensor:
    """``out[r, c] = img[r + orow, c + ocol]``, zero outside."""
    h, w = img.shape[-2:]
    out = torch.zeros_like(img)
    rs, re = max(0, -orow), min(h, h - orow)
    cs, ce = max(0, -ocol), min(w, w - ocol)
    out[..., rs:re, cs:ce] = img[..., rs + orow:re + orow,
                                 cs + ocol:ce + ocol]
    return out


def gradient_smoothness(flow: torch.Tensor, weights) -> torch.Tensor:
    """Mean absolute central difference of the ``[2, H, W]`` flow along
    both axes (one-sided at the edges), each difference times the weight
    at its pixel."""
    total = 0.0
    for axis in (1, 2):
        n = flow.shape[axis]
        wa = axis - 1

        def wsl(a, b):
            if isinstance(weights, float):
                return weights
            return weights.narrow(wa, a, b - a)

        total = total + torch.sum(abs_jax(
            (flow.narrow(axis, 2, n - 2) - flow.narrow(axis, 0, n - 2)) * 0.5
            * wsl(1, n - 1)))
        total = total + torch.sum(abs_jax(
            (flow.narrow(axis, 1, 1) - flow.narrow(axis, 0, 1)) * wsl(0, 1)))
        total = total + torch.sum(abs_jax(
            (flow.narrow(axis, n - 1, 1) - flow.narrow(axis, n - 2, 1))
            * wsl(n - 1, n)))
    return total / flow.numel()


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_losses(objective, x0: torch.Tensor, steps: int, lr: float
                ) -> np.ndarray:
    """The losses of the first ``steps`` iterates of Adam (constant
    learning rate ``lr``, bias-corrected moments) from ``x0``: entry k is
    the objective at the iterate before the k-th update."""
    x = x0.clone()
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    losses = []
    for k in range(steps):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = objective(xg)
            (g,) = torch.autograd.grad(loss, xg)
        losses.append(float(loss.detach()))
        c = k + 1
        mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * g * g + ADAM_B2 * nu
        step = (mu / (1 - ADAM_B1 ** c)) / (
            torch.sqrt(nu / (1 - ADAM_B2 ** c)) + ADAM_EPS)
        x = x - lr * step
    return np.asarray(losses)
