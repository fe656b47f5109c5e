"""Plain reference of the dense ``contrast_maximization`` solve (Shiba et
al., "Secrets of Event-Based Optical Flow", ECCV 2022, with the time-binned
image warp of the JAX package's CMax, as configured by ``cmax_dense``).

Per window: the events inside the ROI, each in one of ``B`` equal time bins
over their span (computed from the float32 timestamps the configuration's
precision gives the event record), voted into per-bin histograms over the
ROI widened by the warp radius ``R``.  Per step of the coarsest scale: the
patch flow interpolated to that box; bin ``b``'s histogram moved by
``−dt_b · flow`` with the bilinear hat weights of the ``(2R+1)²`` taps
around each pixel, summed over the bins; blurred; cropped to the ROI; the
loss ``−Var(IWE) + λ · TV(flow)``; Adam.  The hat's derivative is
``−sign(a)`` inside its support and 0 at its kinks (as in the JAX
package's kernel), which is not what autodiff of ``max(1 − |a|, 0)``
gives there; the flow starts at 0, where every tap sits on a kink.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from . import common
from .common import schedule_faults  # noqa: F401  (the harness's check)

#: the facade returns the pattern displacement itself
FLOW_SIGN = 1.0
TIME_BINS = 16      # CmaxSpec's defaults, which the facade keeps
WARP_RADIUS = 2
DIRECTION_FRAC = 0.5  # warp_direction "middle"


def box(config: dict):
    h, w = config["image_size"]
    x0, x1, y0, y1 = common.roi(config)
    r = WARP_RADIUS
    return max(0, x0 - r), min(h, x1 + r), max(0, y0 - r), min(w, y1 + r)


def histograms(window, config: dict, dtype, device):
    """The ``[B, bh, bw]`` per-bin histograms over the widened ROI box and
    the bins' times ``dt_b`` (centers relative to the window's middle, in
    the window's unit)."""
    ev = common.roi_events(window.events, config, torch.float64, device)
    t = ev[:, 2].to(torch.float32)
    span = torch.clamp(t.max() - t.min(), min=1e-30)
    frac = torch.clamp((t - t.min()) / span, 0.0, 1.0)
    bins = torch.clamp(torch.floor(frac * TIME_BINS).to(torch.int32), 0,
                       TIME_BINS - 1)
    bx0, bx1, by0, by1 = box(config)
    hists = common.vote(ev[:, 0].to(dtype), ev[:, 1].to(dtype),
                        torch.ones(len(ev), dtype=dtype, device=device),
                        (bx1 - bx0, by1 - by0), planes=TIME_BINS, plane=bins,
                        origin=(bx0, by0))
    dts = ((torch.arange(TIME_BINS, dtype=torch.float32) + 0.5) / TIME_BINS
           - DIRECTION_FRAC).to(device=device, dtype=dtype)
    return hists, dts


def _hat(a):
    return torch.clamp(1.0 - torch.abs(a), min=0.0)


def _dhat(a):
    return torch.where(torch.abs(a) < 1.0, -torch.sign(a), 0.0)


class _BinnedWarp(torch.autograd.Function):
    """``iwe(x) = Σ_b Σ_o hat(u_b + o_r)·hat(v_b + o_c)·H_b(x + o)``,
    ``(u_b, v_b) = −dt_b·flow(x)``, differentiable in the flow."""

    @staticmethod
    def forward(ctx, hists, flow, dts):
        ctx.save_for_backward(hists, flow, dts)
        nd = -dts[:, None, None]
        u, v = nd * flow[0], nd * flow[1]
        out = torch.zeros(hists.shape[1:], dtype=hists.dtype,
                          device=hists.device)
        for orow in range(-WARP_RADIUS, WARP_RADIUS + 1):
            wr = _hat(u + orow)
            for ocol in range(-WARP_RADIUS, WARP_RADIUS + 1):
                out += torch.sum(wr * _hat(v + ocol)
                                 * common.shift(hists, orow, ocol), dim=0)
        return out

    @staticmethod
    def backward(ctx, g):
        hists, flow, dts = ctx.saved_tensors
        nd = -dts[:, None, None]
        u, v = nd * flow[0], nd * flow[1]
        du = torch.zeros_like(g)
        dv = torch.zeros_like(g)
        for orow in range(-WARP_RADIUS, WARP_RADIUS + 1):
            wr, dwr = _hat(u + orow), _dhat(u + orow)
            for ocol in range(-WARP_RADIUS, WARP_RADIUS + 1):
                wc, dwc = _hat(v + ocol), _dhat(v + ocol)
                gh = g * common.shift(hists, orow, ocol)
                du += torch.sum(nd * dwr * wc * gh, dim=0)
                dv += torch.sum(nd * wr * dwc * gh, dim=0)
        return None, torch.stack([du, dv]), None


def objective(hists, dts, config: dict, patch: int):
    """The loss of a ``[2, gh, gw]`` patch flow."""
    solver = config["solver"]
    cm = solver.get("cmax", {})
    weights = dict(cm.get("contrast_weights", {"image_variance": 1.0}))
    if set(weights) != {"image_variance"}:
        raise ValueError("the reference has the image variance only")
    smooth = float(cm.get("smoothness", 0.01))
    sigma = float(cm.get("iwe_sigma", 1.0))
    bx0, bx1, by0, by1 = box(config)
    x0, x1, y0, y1 = common.roi(config)
    mh, mw_t = common.dense_matrices(config["image_size"], patch,
                                     np.arange(bx0, bx1), np.arange(by0, by1),
                                     hists.dtype, hists.device)

    def loss(p: torch.Tensor) -> torch.Tensor:
        flow = mh @ p @ mw_t
        iwe = _BinnedWarp.apply(hists, flow, dts)
        if sigma:
            iwe = common.blur(iwe, sigma, "reflect")
        iwe = iwe[x0 - bx0:x1 - bx0, y0 - by0:y1 - by0]
        total = -(float(weights["image_variance"])
                  * torch.var(iwe, correction=0))
        if smooth:
            total = total + smooth * common.gradient_smoothness(flow, 1.0)
        return total

    return loss


def trajectories(windows: Sequence, solves: Sequence, config: dict,
                 seed: int, steps: int, device) -> Dict[int, np.ndarray]:
    """The reference's first ``steps`` losses of each solve in ``solves``
    (``(solve_index, window_index)`` pairs), in float64.  The dense solve
    starts from flow 0, so solves of one window share one trajectory."""
    del seed  # the solve draws nothing
    dtype = torch.float64
    solver = config["solver"]
    patch = int(solver.get("patch_eklt", {}).get("coarsest_patch_size", 64))
    lr = float(np.float32(solver.get("optimizer", {}).get("lr", 0.05)))
    shape = common.grid_shape(config["image_size"], patch)
    out = {}
    for wi in sorted({w for _s, w in solves}):
        hists, dts = histograms(windows[wi], config, dtype, device)
        losses = common.adam_losses(objective(hists, dts, config, patch),
                                    torch.zeros((2,) + shape, dtype=dtype,
                                                device=device), steps, lr)
        for s, w in solves:
            if w == wi:
                out[s] = losses
        del hists
    return out


def field_checks(frames: Sequence, windows: Sequence, config: dict,
                 seed: int, device) -> Dict[str, float]:
    """The program's best field of the finest scale (each frame's
    ``fields[-1]``) against its frame:

    - ``best_gap``: over every frame, the relative gap between the least
      loss of the finest scale's history and the reference's objective at
      that field;
    - ``flow_gap``: over every frame, the largest gap between the flow the
      program returned and the field's patch flow interpolated to the
      frame, over the largest of the latter.

    Each is inf where a frame has no field or no history."""
    del seed
    dtype = torch.float64
    h, w = config["image_size"]
    patch = int(config["solver"]["patch_eklt"]["finest_patch_size"])
    out = {"best_gap": 0.0, "flow_gap": 0.0}
    if any(not f.fields or not len(f.losses) for f in frames):
        return {k: math.inf for k in out}
    mh, mw_t = common.dense_matrices((h, w), patch, np.arange(h),
                                     np.arange(w), dtype, device)
    for wi in sorted({f.window for f in frames}):
        hists, dts = histograms(windows[wi], config, dtype, device)
        loss = objective(hists, dts, config, patch)
        for f in frames:
            if f.window != wi:
                continue
            hist = np.asarray(f.losses[-1], np.float64)
            if hist.size == 0 or not np.all(np.isfinite(hist)):
                return {k: math.inf for k in out}
            field = torch.as_tensor(f.fields[-1]).to(device=device,
                                                     dtype=dtype)
            with torch.no_grad():
                at_best = float(loss(field))
            out["best_gap"] = max(out["best_gap"], float(
                abs(hist.min() - at_best) / abs(at_best)))
            flow = mh @ field @ mw_t
            got = torch.as_tensor(np.asarray(f.flow)).to(device=device,
                                                         dtype=dtype)
            out["flow_gap"] = max(out["flow_gap"], float(
                torch.amax(torch.abs(got - flow))
                / torch.amax(torch.abs(flow))))
        del hists
    return out


def assembly_faults(flow: np.ndarray, config: dict) -> int:
    """Non-finite pixels of the flow (the dense flow covers the frame)."""
    del config
    return int(np.count_nonzero(~np.isfinite(flow)))
