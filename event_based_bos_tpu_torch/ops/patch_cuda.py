"""The independent patch objective and its gradient on a hand-written CUDA
kernel.

:func:`patch_objective` is the tiled solver's per-patch objective
(``solver/patch.py::_patch_objective``) over a whole batch of 4×4 patches
at once, for the velocity model with the pattern shift ``θ = (vx, vy, px,
py)``, a signed prediction without event-hist weights, and a hybrid cost
of ``diff_norm``, ``image_gradient`` and ``flow_norm_pxy`` with numeric
weights (:func:`term_weights`).  It is differentiable with respect to θ:
the forward computes each patch's loss **and** its gradient, and the
backward scales that gradient by the loss's cotangent.

:func:`patch_objective_fwd` launches ``csrc/patch_objective.cu``'s kernel
for CUDA tensors (float32, contiguous; it raises on anything else, there
is no fallback).  :func:`patch_objective_plain` is the kernel's
specification in plain PyTorch: the same arithmetic batched over the
patches, with the gradient derived by hand.  ``patch_objective_fwd`` runs
it for CPU tensors, so that the wrapper can be tested without a card; the
solver never takes that route (it picks the kernel for windows on the
card only).  The JAX package has no kernel here: its objective is plain
JAX, vmapped.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import kernels

__all__ = ["SIDE", "TERMS", "term_weights", "patch_objective",
           "patch_objective_fwd", "patch_objective_plain"]

#: the patch side the kernel takes (4 lanes a patch, one a row)
SIDE = 4
#: the cost terms the kernel computes, in the order of its weights
TERMS = ("diff_norm", "flow_norm_pxy")
#: a term the kernel takes and leaves out: the smoothness of the patch's
#: constant flow, whose value and gradient are 0
ZERO_TERMS = ("image_gradient",)
NORM_EPS = 1e-4  # as solver/generative.py's


def term_weights(cost_weights) -> Optional[Tuple[float, float]]:
    """The weights of :data:`TERMS` in the hybrid cost ``cost_weights``
    (pairs or a dict of name → weight; an absent term weighs 0), or None
    where the cost has a term outside :data:`TERMS` and
    :data:`ZERO_TERMS` or a weight that is not a number (``"inv"``)."""
    weights = dict(cost_weights)
    if set(weights) - set(TERMS) - set(ZERO_TERMS):
        return None
    if any(isinstance(w, bool) or not isinstance(w, (int, float))
           for w in weights.values()):
        return None
    return tuple(float(weights.get(name, 0.0)) for name in TERMS)


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _abs_grad(x):
    """``(|x|, d|x|/dx)`` with JAX's derivative, +1 at 0."""
    pos = x >= 0
    return torch.where(pos, x, -x), torch.where(pos, 1.0, -1.0).to(x.dtype)


def patch_objective_plain(theta: torch.Tensor, measured: torch.Tensor,
                          gx: torch.Tensor, gy: torch.Tensor,
                          weights: Sequence[float]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's specification: each patch's loss ``[n]`` and its
    gradient ``[n, 4]`` with respect to ``θ = (vx, vy, px, py)`` ``[n,
    4]``, for the windows ``[n, 4, 4]`` and the weights of :data:`TERMS`,
    in the inputs' dtype.  The value is ``_patch_objective``'s: the
    gradients sampled bilinearly at ``(r − px, c − py)`` (zero outside the
    window), the prediction ``vx·gx + vy·gy`` over its Frobenius norm +
    1e-4 (a zero subgradient where it is exactly 0), the induced 1-norm of
    its difference from the measurement (tied columns share the gradient
    evenly), and ``|(px, py)|`` (a zero subgradient at the origin).  The
    smoothness of the constant patch flow is 0, value and gradient."""
    w_diff, w_pxy = weights
    n = theta.shape[0]
    vx, vy, px, py = theta.unbind(1)
    k = torch.arange(SIDE, dtype=theta.dtype, device=theta.device)
    rows = k[None, :, None] - px[:, None, None]     # [n, 4, 1]
    cols = k[None, None, :] - py[:, None, None]     # [n, 1, 4]
    r0, c0 = torch.floor(rows), torch.floor(cols)
    dr, dc = rows - r0, cols - c0
    batch = torch.arange(n, device=theta.device)[:, None, None]

    # the shift's taps in sample_bilinear's order: their values (0 outside
    # the window) and the weights' derivatives along dr and dc
    taps = []
    gxs = gys = 0.0
    for a, b in ((0, 0), (1, 0), (0, 1), (1, 1)):
        w_r = dr if a else 1 - dr
        w_c = dc if b else 1 - dc
        rr, cc = r0 + a, c0 + b
        inside = (rr >= 0) & (rr < SIDE) & (cc >= 0) & (cc < SIDE)
        ri = rr.clamp(0, SIDE - 1).long()
        ci = cc.clamp(0, SIDE - 1).long()
        wt = w_r * w_c
        tx = _where0(inside, gx[batch, ri, ci])
        ty = _where0(inside, gy[batch, ri, ci])
        gxs = gxs + _where0(inside, gx[batch, ri, ci] * wt)
        gys = gys + _where0(inside, gy[batch, ri, ci] * wt)
        taps.append((tx, ty, w_c if a else -w_c, w_r if b else -w_r))

    # the prediction, normalized, against the measurement
    pred = vx[:, None, None] * gxs + vy[:, None, None] * gys
    sq = (pred * pred).sum((1, 2))
    flat = sq == 0
    norm = _where0(~flat, torch.sqrt(torch.where(flat, 1.0, sq)))
    denom = (norm + NORM_EPS)[:, None, None]
    pn = pred / denom
    diff = pn - measured
    size, sign = _abs_grad(diff)
    column = size.sum(1)                              # [n, 4]
    largest = torch.amax(column, 1)
    top = column == largest[:, None]
    g_column = (w_diff / top.sum(1, keepdim=True).to(theta.dtype)) * top
    g_pn = sign * g_column[:, None, :]

    # back through the normalization
    g_denom = -(g_pn * (pn / denom)).sum((1, 2))
    g_sq = _where0(~flat, g_denom / (2 * torch.where(flat, 1.0, norm)))
    g_pred = g_pn / denom + 2 * g_sq[:, None, None] * pred

    # back through the prediction and the shift (rows = r − px)
    cx = g_pred * vx[:, None, None]
    cy = g_pred * vy[:, None, None]
    g_dr = g_dc = 0.0
    for tx, ty, w_dr, w_dc in taps:
        g_w = cx * tx + cy * ty
        g_dr = g_dr + g_w * w_dr
        g_dc = g_dc + g_w * w_dc

    psq = px * px + py * py
    origin = psq == 0
    shift_norm = _where0(~origin, torch.sqrt(torch.where(origin, 1.0, psq)))
    g_shift = _where0(~origin, w_pxy / torch.where(origin, 1.0, shift_norm))

    loss = w_diff * largest + w_pxy * shift_norm
    grad = torch.stack([
        (g_pred * gxs).sum((1, 2)),
        (g_pred * gys).sum((1, 2)),
        -g_dr.sum((1, 2)) + g_shift * px,
        -g_dc.sum((1, 2)) + g_shift * py], 1)
    return loss, grad


def _check(theta: torch.Tensor, windows: Sequence[torch.Tensor]) -> None:
    if theta.dim() != 2 or theta.shape[1] != 4:
        raise ValueError(f"theta must be [n, 4], got {tuple(theta.shape)}")
    want = (theta.shape[0], SIDE, SIDE)
    for name, w in zip(("measured", "gx", "gy"), windows):
        if tuple(w.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got "
                             f"{list(w.shape)}")
        if w.device != theta.device or w.dtype != theta.dtype:
            raise ValueError(f"{name} must share theta's device and dtype "
                             f"({theta.device}, {theta.dtype}), got "
                             f"({w.device}, {w.dtype})")
    if theta.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {theta.device}")


def patch_objective_fwd(theta: torch.Tensor, measured: torch.Tensor,
                        gx: torch.Tensor, gy: torch.Tensor,
                        weights: Sequence[float]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each patch's loss ``[n]`` and gradient ``[n, 4]``, without autograd:
    the kernel for CUDA tensors (float32, contiguous, on 16 bytes, or it
    raises), the plain version for CPU tensors (a route for tests)."""
    windows = (measured, gx, gy)
    _check(theta, windows)
    if theta.device.type == "cpu":
        return patch_objective_plain(theta, *windows, weights)
    if theta.dtype != torch.float32:
        raise TypeError(f"the patch objective kernel takes float32, got "
                        f"{theta.dtype}")
    if not all(t.is_contiguous() for t in (theta,) + windows):
        raise ValueError("the patch objective kernel takes contiguous "
                         "theta and windows")
    if any(t.data_ptr() % 16 for t in (theta,) + windows):
        raise ValueError("the patch objective kernel reads rows of 4 floats "
                         "as 16-byte words: theta and the windows must "
                         "start on 16 bytes")
    n = theta.shape[0]
    with torch.cuda.device(theta.device):
        loss = torch.empty((n,), dtype=torch.float32, device=theta.device)
        grad = torch.empty((n, 4), dtype=torch.float32, device=theta.device)
        if n == 0:
            return loss, grad
        w_diff, w_pxy = (float(w) for w in weights)
        err = kernels.library().ebt_patch_objective(
            theta.data_ptr(), measured.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), n, w_diff, w_pxy,
            loss.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream(theta.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"patch objective kernel launch failed "
                           f"(cudaError {err})")
    kernels.launched("patch_objective")
    return loss, grad


class _PatchObjective(torch.autograd.Function):

    @staticmethod
    def forward(ctx, theta, measured, gx, gy, weights):
        loss, grad = patch_objective_fwd(theta.detach(), measured, gx, gy,
                                         weights)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        # the gradient is computed, not a graph: it has no derivative of
        # its own, so a second derivative must fail rather than come out 0
        if torch.is_grad_enabled():
            raise RuntimeError(
                "patch_objective has no second derivative: its backward "
                "cannot run under create_graph=True")
        (grad,) = ctx.saved_tensors
        return g[:, None] * grad, None, None, None, None


def patch_objective(theta: torch.Tensor, measured: torch.Tensor,
                    gx: torch.Tensor, gy: torch.Tensor,
                    weights: Sequence[float]) -> torch.Tensor:
    """Each patch's loss ``[n]`` at ``θ`` ``[n, 4]`` for its windows ``[n,
    4, 4]`` (the normalized measurement and the two gradients) and the
    weights of :data:`TERMS`; differentiable with respect to ``θ`` (the
    windows are constants)."""
    return _PatchObjective.apply(theta, measured, gx, gy, tuple(weights))
