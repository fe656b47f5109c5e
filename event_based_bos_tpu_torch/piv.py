"""Particle image velocimetry: batched multipass window deformation.

PyTorch counterpart of the JAX package's ``piv.py``, the algorithm of
OpenPIV's ``windef`` multipass (Settles & Liberzon 2022): every
interrogation window of a pass is cross-correlated at once through FFTs
(``torch.fft``), the peak found with a 3-point Gaussian sub-pixel fit,
the vectors validated (displacement box, global std, 3×3 median, optional
signal-to-noise) and the invalid ones replaced by the local mean of valid
neighbours, then smoothed (``smoothn``) and resized to a dense field that
deforms the next pass's windows.

:func:`piv_multipass` uploads the two frames once, runs every pass on the
device and fetches the dense field once.  It runs on the GPU unless the
caller asks for another device, in float32 unless asked for another
dtype.  Used by the PIV ground truth (``method: openpiv``) and by the
event-grid PIV (``estimation_method: openpiv``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .device import resolve_device
from .ops.image_warp import resize_bilinear, sample_bilinear
from .utils.config import PivSettings

__all__ = ["piv_pass", "piv_multipass", "smoothn", "dct2_matrix"]


def _window_grid(shape, window: int, overlap: int):
    """Top-left rows and columns of the interrogation windows."""
    h, w = shape
    stride = window - overlap
    return (np.arange(0, h - window + 1, stride),
            np.arange(0, w - window + 1, stride))


def _extract_windows(img: torch.Tensor, window: int, stride: int
                     ) -> torch.Tensor:
    """Every ``window × window`` window at the grid's corners, row-major:
    ``[n, window, window]``."""
    tiles = img.unfold(0, window, stride).unfold(1, window, stride)
    return tiles.reshape(-1, window, window)


def _gaussian_subpixel(corr: torch.Tensor, peak_r, peak_c):
    """3-point Gaussian peak interpolation (OpenPIV's ``gaussian``), 0
    where the fit is not finite."""
    n, wh, ww = corr.shape
    eps = 1e-12
    idx = torch.arange(n, device=corr.device)

    def val(dr, dc):
        r = (peak_r + dr).clamp(0, wh - 1)
        c = (peak_c + dc).clamp(0, ww - 1)
        return torch.clamp(corr[idx, r, c], min=eps)

    l0 = torch.log(val(0, 0))
    ll, lr = torch.log(val(-1, 0)), torch.log(val(1, 0))
    ld, lu = torch.log(val(0, -1)), torch.log(val(0, 1))
    dr = (ll - lr) / (2 * ll - 4 * l0 + 2 * lr - eps)
    dc = (ld - lu) / (2 * ld - 4 * l0 + 2 * lu - eps)
    return (torch.nan_to_num(dr, nan=0.0, posinf=0.0, neginf=0.0),
            torch.nan_to_num(dc, nan=0.0, posinf=0.0, neginf=0.0))


def _correlate(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Circular FFT cross-correlation of the mean-subtracted window
    batches, zero displacement at the window's centre."""
    wa = wa - wa.mean(dim=(-2, -1), keepdim=True)
    wb = wb - wb.mean(dim=(-2, -1), keepdim=True)
    fa = torch.fft.rfft2(wa)
    fb = torch.fft.rfft2(wb)
    corr = torch.fft.irfft2(torch.conj(fa) * fb, s=wa.shape[-2:])
    return torch.fft.fftshift(corr, dim=(-2, -1))


def _sig2noise(corr: torch.Tensor, peak_r, peak_c, method: str, mask: int):
    """The peak-to-peak (or peak-to-mean) detectability ratio."""
    n, wh, ww = corr.shape
    peak1 = corr[torch.arange(n, device=corr.device), peak_r, peak_c]
    if method == "peak2mean":
        return peak1 / torch.clamp(torch.abs(corr).mean(dim=(-2, -1)),
                                   min=1e-12)
    rr = torch.arange(wh, device=corr.device)[None, :, None]
    cc = torch.arange(ww, device=corr.device)[None, None, :]
    near = ((torch.abs(rr - peak_r[:, None, None]) <= mask)
            & (torch.abs(cc - peak_c[:, None, None]) <= mask))
    peak2 = torch.where(near, -torch.inf, corr).amax(dim=(-2, -1))
    return peak1 / torch.clamp(peak2, min=1e-12)


def piv_pass(frame_a: torch.Tensor, frame_b: torch.Tensor, window: int,
             overlap: int, settings: PivSettings):
    """One correlation pass: ``(u_col, v_row, s2n)`` on the window grid,
    the displacement of the pattern from ``frame_a`` to ``frame_b``."""
    rows, cols = _window_grid(frame_a.shape, window, overlap)
    stride = window - overlap
    corr = _correlate(_extract_windows(frame_a, window, stride),
                      _extract_windows(frame_b, window, stride))
    n = corr.shape[0]
    peak = torch.argmax(corr.reshape(n, -1), dim=-1)  # the first maximum
    pr = peak // window
    pc = peak % window
    dr_sub, dc_sub = _gaussian_subpixel(corr, pr, pc)
    disp_r = pr.to(corr.dtype) + dr_sub - window // 2
    disp_c = pc.to(corr.dtype) + dc_sub - window // 2
    s2n = _sig2noise(corr, pr, pc, settings.sig2noise_method,
                     settings.sig2noise_mask)
    gh, gw = len(rows), len(cols)
    return (disp_c.reshape(gh, gw), disp_r.reshape(gh, gw),
            s2n.reshape(gh, gw))


def _validate(u, v, s2n, settings: PivSettings) -> torch.Tensor:
    """Invalid vectors: outside the displacement box, beyond
    ``std_threshold`` global standard deviations (ddof 0), beyond
    ``median_threshold`` from the 3×3 edge-padded median, or (optionally)
    below the signal-to-noise threshold."""
    lo_u, hi_u = settings.min_max_u_disp
    lo_v, hi_v = settings.min_max_v_disp
    bad = (u < lo_u) | (u > hi_u) | (v < lo_v) | (v > hi_v)
    for f in (u, v):
        sd = torch.clamp(torch.std(f, correction=0), min=1e-12)
        bad |= torch.abs(f - torch.mean(f)) > settings.std_threshold * sd

    def med3(f):
        p = F.pad(f[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        stack = torch.stack([p[i:i + f.shape[0], j:j + f.shape[1]]
                             for i in range(3) for j in range(3)])
        return torch.median(stack, dim=0).values  # of 9: the exact middle

    bad |= torch.abs(u - med3(u)) > settings.median_threshold
    bad |= torch.abs(v - med3(v)) > settings.median_threshold
    if settings.sig2noise_validate:
        bad |= s2n < settings.sig2noise_threshold
    return bad


def _replace_localmean(u, v, bad, iterations: int, ksize: int):
    """Replace the invalid vectors by the mean of their valid neighbours in
    the ``(2k+1)²`` window (OpenPIV's ``replace_nans(method="localmean")``):
    each round fills only the invalid cells with a valid neighbour, and the
    filled cells count as valid in the next round, so holes erode inward.
    Cells still unfilled after the last round take the global mean of the
    valid vectors (0 when none is valid)."""
    k = 2 * ksize + 1
    kernel = torch.ones((1, 1, k, k), dtype=u.dtype, device=u.device)
    kernel[0, 0, ksize, ksize] = 0.0

    def conv(f):
        return F.conv2d(f[None, None], kernel, padding=ksize)[0, 0]

    for _ in range(iterations):
        good = (~bad).to(u.dtype)
        cnt = conv(good)
        fillable = bad & (cnt > 0)
        denom = torch.clamp(cnt, min=1.0)
        u = torch.where(fillable, conv(u * good) / denom, u)
        v = torch.where(fillable, conv(v * good) / denom, v)
        bad = bad & ~fillable
    n_good = torch.clamp((~bad).sum(), min=1)
    mean_u = torch.where(bad, 0.0, u).sum() / n_good
    mean_v = torch.where(bad, 0.0, v).sum() / n_good
    return torch.where(bad, mean_u, u), torch.where(bad, mean_v, v)


@functools.lru_cache(maxsize=None)
def _dct2_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix ``C`` with ``dct(x, norm='ortho') = C @ x``
    (``scipy.fft``): ``C[k, j] = f_k cos(π k (2j+1) / (2n))``, ``f_0 =
    √(1/n)``, else ``√(2/n)``; ``C⁻¹ = Cᵀ``."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    c = np.cos(np.pi * k * (2 * j + 1) / (2 * n)) * np.sqrt(2.0 / n)
    c[0] = np.sqrt(1.0 / n)
    return c


@functools.lru_cache(maxsize=32)
def dct2_matrix(n: int, dtype: torch.dtype, device: torch.device
                ) -> torch.Tensor:
    """The ``[n, n]`` DCT-II matrix on ``device`` in ``dtype``, built once
    per (n, dtype, device); callers must not write into it."""
    return torch.as_tensor(_dct2_matrix_np(int(n))).to(device=device,
                                                       dtype=dtype)


@functools.lru_cache(maxsize=32)
def _smoothn_gain(n: int, m: int, s: float, dtype, device) -> torch.Tensor:
    lam = ((-2.0 + 2.0 * np.cos(np.pi * np.arange(n) / n))[:, None]
           + (-2.0 + 2.0 * np.cos(np.pi * np.arange(m) / m))[None, :])
    return torch.as_tensor(1.0 / (1.0 + s * lam * lam)).to(device=device,
                                                           dtype=dtype)


def smoothn(f: torch.Tensor, s: float) -> torch.Tensor:
    """DCT penalized-least-squares smoothing (Garcia 2010) with a given
    ``s`` and uniform weights, OpenPIV's ``smoothn`` between passes:

        z = IDCT( Γ ⊙ DCT(y) ),   Γ = 1 / (1 + s·Λ²),
        Λ[i, j] = (−2 + 2cos(πi/n)) + (−2 + 2cos(πj/m)),

    with the orthonormal 2-D DCT-II as two matrix products (TF32 must be
    off on the card: it would round them).
    """
    n, m = f.shape
    cn = dct2_matrix(n, f.dtype, f.device)
    cm = dct2_matrix(m, f.dtype, f.device)
    gain = _smoothn_gain(n, m, float(s), f.dtype, f.device)
    return cn.T @ (gain * (cn @ f @ cm.T)) @ cm


def _one_iteration(frame_a, frame_b, window: int, overlap: int,
                   settings: PivSettings, prev_dense, is_last: bool):
    """One pass: the windows deformed by the previous dense field (when
    given), correlated, the field added back at the window centres,
    validated, replaced, smoothed (the first pass always, later passes
    only when more follow) and resized to the frame."""
    h, w = frame_a.shape
    if prev_dense is not None:
        gr, gc = torch.meshgrid(
            torch.arange(h, dtype=frame_a.dtype, device=frame_a.device),
            torch.arange(w, dtype=frame_a.dtype, device=frame_a.device),
            indexing="ij")
        du_c, du_r = prev_dense[0], prev_dense[1]
        if settings.deformation_method == "symmetric":
            fa = sample_bilinear(frame_a, gr - du_r / 2, gc - du_c / 2)
            fb = sample_bilinear(frame_b, gr + du_r / 2, gc + du_c / 2)
        else:  # "second image"
            fa = frame_a
            fb = sample_bilinear(frame_b, gr + du_r, gc + du_c)
    else:
        fa, fb = frame_a, frame_b

    u, v, s2n = piv_pass(fa, fb, window, overlap, settings)
    if prev_dense is not None:
        rows, cols = _window_grid((h, w), window, overlap)
        rr = torch.as_tensor(rows + window // 2, device=u.device)
        cc = torch.as_tensor(cols + window // 2, device=u.device)
        u = u + prev_dense[0][rr[:, None], cc[None, :]]
        v = v + prev_dense[1][rr[:, None], cc[None, :]]
    bad = _validate(u, v, s2n, settings)
    if settings.replace_vectors:
        u, v = _replace_localmean(u, v, bad, settings.max_filter_iteration,
                                  settings.filter_kernel_size)
    if settings.smoothn and (prev_dense is None or not is_last):
        u = smoothn(u, settings.smoothn_p)
        v = smoothn(v, settings.smoothn_p)
    return torch.stack([resize_bilinear(u, (h, w)),
                        resize_bilinear(v, (h, w))])


def piv_multipass(frame_a, frame_b, settings: PivSettings, device=None,
                  dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The full multipass window-deformation PIV between two frames.

    Returns a dense ``[2, H, W]`` numpy displacement field in the
    reference GT layout (channel 0 the column displacement, channel 1 the
    row displacement), zero outside ``settings.roi`` when one is set.
    Passes whose window exceeds the (ROI-cropped) frame are skipped.
    """
    dev = resolve_device(device)
    fa = torch.as_tensor(np.asarray(frame_a)).to(device=dev, dtype=dtype)
    fb = torch.as_tensor(np.asarray(frame_b)).to(device=dev, dtype=dtype)
    if settings.roi is not None:
        x0, x1, y0, y1 = settings.roi
        fa, fb = fa[x0:x1, y0:y1], fb[x0:x1, y0:y1]
    else:
        x0 = y0 = 0
        x1, y1 = fa.shape
    passes = [(int(w_), int(o_))
              for w_, o_ in zip(settings.windowsizes, settings.overlap)
              if min(fa.shape) >= w_]
    if not passes:
        raise ValueError("Frames smaller than every interrogation window")
    dense: Optional[torch.Tensor] = None
    for i, (window, overlap) in enumerate(passes):
        dense = _one_iteration(fa, fb, window, overlap, settings, dense,
                               i == len(passes) - 1)
    dense = dense / settings.scaling_factor / settings.dt
    out = np.zeros((2,) + tuple(np.shape(frame_a)),
                   torch.empty(0, dtype=dtype).numpy().dtype)
    out[:, x0:x1, y0:y1] = dense.cpu().numpy()
    return out
