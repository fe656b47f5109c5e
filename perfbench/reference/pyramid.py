"""Plain reference of the ``patch_eklt_pyramid2`` solve (the generative
model of Shiba et al., T-PAMI 2023, as configured by ``hot_plate1``).

Per window: the signed vote of the events inside the ROI, its Gaussian
blur (the measurement, L2-normalized over the frame, times the ROI mask)
and the inverse-event weight map; the frame's Sobel gradients.  Per step
of the coarsest scale: the Poisson potential's Sobel/8 flow and the
pattern shift, interpolated from the patch grid to the frame; the
gradients shifted by the 4-tap stencil; the prediction ``flow · ∇I``
L2-normalized and masked; the cost
``‖pred − meas‖₁ (induced) + 0.5·TV_w(flow) + 0.1·mean|pxy|``; Adam.

The whole solve decorrelates between any two float32 runs, so the
reference follows the program over the first steps of each scale from
that scale's start: the coarsest from the start the facade draws (a
``U(−1, 1)`` potential a patch from a generator seeded by the run's seed,
one draw a solve, in dispatch order), each finer one from the bilinear
prolongation of the program's best field of the scale before.  It
evaluates its objective at the program's best field of every scale, and
works out the flow the solve returns from the finest one.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import common
from .common import schedule_faults  # noqa: F401  (the harness's check)

#: the facade returns −(pattern displacement) (the reference convention)
FLOW_SIGN = -1.0
NORM_EPS = 1e-4
#: the induced 1-norm's subgradient follows its largest column; when the
#: two largest column sums lie closer than this (relative), float32 and
#: float64 may take different columns, and the steps after that one are
#: not compared (a float32 column sum of 720 terms is good to ~2e-6)
TIE_MARGIN = 1e-5


def _solver(config: dict) -> dict:
    return config["solver"]


def coarsest_patch(config: dict) -> int:
    return int(_solver(config)["patch_eklt"]["coarsest_patch_size"])


def patches(config: dict) -> List[int]:
    """The patch size of each scale, coarsest first."""
    return [coarsest_patch(config) // 2 ** i
            for i in range(len(common.schedule(config)))]


def starts(config: dict, seed: int, solves: int, device) -> List[torch.Tensor]:
    """The coarsest-scale starts of the first ``solves`` solves: the
    potential ``2·U − 1`` (in the solver's dtype) of a generator on
    ``device`` seeded by ``seed``, drawn once a solve; the pattern shift
    starts at 0."""
    g = torch.Generator(device).manual_seed(int(seed))
    shape = common.grid_shape(config["image_size"], coarsest_patch(config))
    dtype = common.solver_dtype(config)
    out = []
    for _ in range(solves):
        x = torch.zeros((3,) + shape, dtype=dtype, device=device)
        x[0] = torch.rand(shape, generator=g, dtype=dtype,
                          device=device) * 2.0 - 1.0
        out.append(x)
    return out


def frame_constants(window, config: dict, dtype, device) -> Dict:
    """A window's measurement, weights, gradients and mask."""
    gml = _solver(config)["generative_ml"]
    h, w = config["image_size"]
    ev = common.roi_events(window.events, config, dtype, device)
    hist = common.vote(ev[:, 0], ev[:, 1],
                       torch.where(ev[:, 3] > 0, 1.0, -1.0).to(dtype),
                       (h, w))[0]
    measured = common.blur(hist, float(gml["iwe_sigma"]), "reflect")
    wi = common.blur(torch.abs(hist), 10.0, "symmetric")
    hi = torch.mean(wi) + torch.std(wi, correction=0) / 2.0
    wi = torch.minimum(torch.clamp(wi, min=0.0), hi)
    weight_inverse = 1.0 - 0.95 * (wi / torch.amax(wi))
    x0, x1, y0, y1 = common.roi(config)
    mask = torch.zeros((h, w), dtype=dtype, device=device)
    mask[x0:x1, y0:y1] = 1.0
    measured = measured / torch.sqrt(torch.sum(measured * measured)) * mask
    frame = torch.as_tensor(window.frame).to(device=device, dtype=dtype)
    gx, gy = common.sobel(frame, "reflect")
    return {"measured": measured, "weight_inverse": weight_inverse,
            "gx": gx, "gy": gy, "mask": mask}


def _warp4(images: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Sample ``images`` at ``(r − u, c − v)`` with the 4-tap stencil that
    extrapolates linearly past one pixel (zero outside the frame)."""
    au, av = common.abs_jax(u), common.abs_jax(v)
    up, vp = u >= 0, v >= 0
    s = common.shift
    i_u = torch.where(up, s(images, -1, 0), s(images, 1, 0))
    i_v = torch.where(vp, s(images, 0, -1), s(images, 0, 1))
    i_uv = torch.where(up, torch.where(vp, s(images, -1, -1),
                                       s(images, -1, 1)),
                       torch.where(vp, s(images, 1, -1), s(images, 1, 1)))
    return ((1 - au) * (1 - av) * images + (1 - au) * av * i_v
            + au * (1 - av) * i_u + au * av * i_uv)


def objective(consts: Dict, config: dict, patch: int, margins=None):
    """The loss of a ``[3, gh, gw]`` field (potential, pattern shift).
    Each evaluation appends to ``margins`` (when given) the relative gap
    between the two largest column sums of the induced norm."""
    h, w = config["image_size"]
    mh, mw_t = common.dense_matrices((h, w), patch, np.arange(h),
                                     np.arange(w), consts["mask"].dtype,
                                     consts["mask"].device)
    weights = dict(_solver(config)["cost_with_weight"])
    mask = consts["mask"]

    def loss(p: torch.Tensor) -> torch.Tensor:
        dx, dy = common.sobel(p[0], "edge")
        fields = mh @ torch.cat([torch.stack([dx, dy]) / 8.0, p[1:3]]) @ mw_t
        flow, pxy = fields[0:2], fields[2:4]
        g = _warp4(torch.stack([consts["gx"], consts["gy"]]), pxy[0], pxy[1])
        pred = flow[0] * g[0] + flow[1] * g[1]
        sq = torch.sum(pred * pred)
        norm = torch.where(sq == 0, 0.0,
                           torch.sqrt(torch.where(sq == 0, 1.0, sq)))
        pred = pred / (norm + NORM_EPS) * mask
        cols = torch.sum(common.abs_jax(pred - consts["measured"]), dim=-2)
        if margins is not None:
            top = torch.topk(cols.detach(), 2).values
            margins.append(float((top[0] - top[1]) / top[0]))
        terms = {
            "diff_norm": torch.amax(cols),
            "image_gradient": common.gradient_smoothness(
                flow * mask, consts["weight_inverse"]),
        }
        pm = pxy * mask
        psq = torch.sum(pm * pm, dim=0)
        terms["flow_norm_pxy"] = torch.mean(torch.where(
            psq == 0, 0.0, torch.sqrt(torch.where(psq == 0, 1.0, psq))))
        total = 0.0
        for name, wgt in weights.items():
            total = total + float(wgt) * terms[name]
        return total

    return loss


def trajectories(windows: Sequence, solves: Sequence, config: dict,
                 seed: int, steps: int, device) -> Dict[int, np.ndarray]:
    """The reference's first ``steps`` losses of each solve in ``solves``
    (``(solve_index, window_index)`` pairs; solve indices count every
    solve since the facade was built), in float64; NaN after a step whose
    induced norm sat on a near-tie (:data:`TIE_MARGIN`)."""
    dtype = torch.float64
    patch = coarsest_patch(config)
    lr = float(np.float32(_solver(config)["optimizer"].get("lr", 0.05)))
    inits = starts(config, seed, max(s for s, _w in solves) + 1, device)
    out = {}
    for wi in sorted({w for _s, w in solves}):
        consts = frame_constants(windows[wi], config, dtype, device)
        for s, w in solves:
            if w == wi:
                margins = []
                loss = objective(consts, config, patch, margins)
                out[s] = common.adam_losses(loss, inits[s].to(dtype), steps,
                                            lr)
                ties = np.flatnonzero(np.asarray(margins) < TIE_MARGIN)
                if len(ties):
                    out[s][ties[0] + 1:] = np.nan
        del consts
    return out


def prolong(field: torch.Tensor, shape) -> torch.Tensor:
    """A coarser scale's field resized to the next scale's grid (bilinear,
    half-pixel centers, clamped at the edges)."""
    gh, gw = field.shape[-2:]
    mh = torch.as_tensor(common.resize_matrix(gh, shape[0])).to(field)
    mw = torch.as_tensor(common.resize_matrix(gw, shape[1])).to(field)
    return mh @ field @ mw.T


def dense_flow(field: torch.Tensor, config: dict, mask: torch.Tensor):
    """The flow the solve returns from its finest field: the potential's
    Sobel/8 flow interpolated to the frame, exactly +0.0 outside the
    ROI."""
    h, w = config["image_size"]
    mh, mw_t = common.dense_matrices((h, w), patches(config)[-1],
                                     np.arange(h), np.arange(w),
                                     field.dtype, field.device)
    dx, dy = common.sobel(field[0], "edge")
    return torch.where(mask != 0, mh @ (torch.stack([dx, dy]) / 8.0) @ mw_t,
                       0.0)


def _rel(got, want) -> np.ndarray:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.abs(want)


def field_checks(frames: Sequence, windows: Sequence, config: dict,
                 seed: int, device) -> Dict[str, float]:
    """The finer scales, the best fields and the flow, against the
    program's frames (each with its per-scale ``losses`` and ``fields``
    on the host):

    - ``scale_gap``: over a sample of ``correct.scale_frames`` frames
      drawn from the seed, the largest relative gap between the program's
      first ``correct.steps`` losses of each finer scale and the
      reference's, which starts from the prolongation of the program's
      best field of the scale before (steps after a near-tie of the
      induced norm not compared);
    - ``best_gap``: over every frame and scale, the relative gap between
      the least loss of the program's history and the reference's
      objective at the program's best field;
    - ``flow_gap``: over every frame, the largest gap between the flow
      the program returned and the one its finest field gives, over the
      largest of the latter.

    Each is inf where a frame has no fields or a history is short."""
    dtype = torch.float64
    corr = config["correct"]
    steps = int(corr["steps"])
    lr = float(np.float32(_solver(config)["optimizer"].get("lr", 0.05)))
    sizes = patches(config)
    n_scales = len(sizes)
    rng = np.random.default_rng(int(seed))
    sample = set(rng.choice(len(frames), min(len(frames),
                                             int(corr["scale_frames"])),
                            replace=False).tolist())
    out = {"scale_gap": 0.0, "best_gap": 0.0, "flow_gap": 0.0}
    if any(f.fields is None or len(f.fields) != n_scales
           or len(f.losses) != n_scales for f in frames):
        return {k: math.inf for k in out}
    for wi in sorted({f.window for f in frames}):
        consts = frame_constants(windows[wi], config, dtype, device)
        margins: List[float] = []
        losses = [objective(consts, config, p, margins) for p in sizes]
        for j, f in enumerate(frames):
            if f.window != wi:
                continue
            fields = [torch.as_tensor(x).to(device=device, dtype=dtype)
                      for x in f.fields]
            for s in range(n_scales):
                hist = np.asarray(f.losses[s], np.float64)
                if hist.size == 0 or not np.all(np.isfinite(hist)):
                    return {k: math.inf for k in out}
                with torch.no_grad():
                    at_best = float(losses[s](fields[s]))
                out["best_gap"] = max(out["best_gap"],
                                      float(_rel(hist.min(), at_best)))
                if s == 0 or j not in sample:
                    continue
                margins.clear()
                want = common.adam_losses(
                    losses[s], prolong(fields[s - 1], fields[s].shape[-2:]),
                    steps, lr)
                if hist.size < steps:
                    return {k: math.inf for k in out}
                ties = np.flatnonzero(np.asarray(margins) < TIE_MARGIN)
                upto = steps if not len(ties) else ties[0] + 1
                out["scale_gap"] = max(out["scale_gap"], float(np.max(
                    _rel(hist[:upto], want[:upto]))))
            flow = dense_flow(fields[-1], config, consts["mask"])
            got = torch.as_tensor(np.asarray(f.flow)).to(device=device,
                                                         dtype=dtype)
            out["flow_gap"] = max(out["flow_gap"], float(
                torch.amax(torch.abs(got - flow)) / torch.amax(
                    torch.abs(flow))))
        del consts
    return out


def assembly_faults(flow: np.ndarray, config: dict) -> int:
    """Pixels outside the ROI that are not exactly +0.0 (the solve selects
    +0.0 there), and non-finite pixels inside it."""
    x0, x1, y0, y1 = common.roi(config)
    outside = np.ones(flow.shape[-2:], bool)
    outside[x0:x1, y0:y1] = False
    bits = np.asarray(flow, np.float32).view(np.uint32)
    return int(np.count_nonzero(bits[:, outside])
               + np.count_nonzero(~np.isfinite(flow[:, ~outside])))
