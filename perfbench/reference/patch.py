"""Plain reference of the ``patch_eklt`` solve: upstream's independent
per-patch solver (``src/solver/patch_eklt.py``) on the generative model of
Shiba et al. (T-PAMI 2023), as ``configs/hot_plate1.yaml``'s
``patch_eklt`` section configures it.

Per window: the signed vote of the events inside the ROI and its Gaussian
blur (σ = ``iwe_sigma``, reflect-101 border), the measured increment; the
frame's 3×3 Sobel gradients.  The grid: square windows of ``patch_size``
px every ``sliding_window`` px (a start that would run past the image's
edge starts at the edge instead); a patch is active when its centre lies
in the ROI, edges included.  Each active patch fits ``θ = (vx, vy, px,
py)`` from 0 on its own window, written here over a patch axis:

- the gradient windows sampled at ``(r − px, c − py)``, bilinear, zero
  outside the window;
- the prediction ``vx·gx + vy·gy`` over its Frobenius norm + 1e-4 (0 for
  a zero prediction, with a zero subgradient there);
- the measurement window over its own Frobenius norm;
- the cost ``‖pred − meas‖₁`` (the induced norm: the largest column sum)
  ``+ 0.1·‖(px, py)‖``.  The smoothness term of a flow that is constant
  over the window is exactly 0, in value and in gradient, and is left
  out;
- Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments) at the
  independent solver's own learning rate of 0.01, times 0.1 every
  ``n_iter`` steps.

The solver reads ``poisson_model`` and ``iwe``'s blur for the pyramid
only: the independent patches fit the velocity itself.  Every patch starts
at 0, so the solves of one window are identical, and the reference
follows each window once, in float64 and in blocks of patches.  The
number compared is the one the facade hands on: each step's loss summed
over the active patches.

The returned flow is the active patches' ``(vx, vy)`` interpolated to the
frame (the grid padded by ``patch / 2 // stride + 1`` patches with its
edge values, resized by the stride with half-pixel centres, centre-cropped
to the image).  The reference holds it to that operator: refitted through
it on the active patches alone, the flow must come back to round-off
(``flow_gap``), the refitted velocities must be the reference's own
``n_iter``-step fit at the typical patch of a sample (``fit_gap``) and at
all but a few of them (``fit_share``), and wherever no active patch
reaches the flow must be exactly +0.0 (``assembly_faults``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Sequence

import numpy as np
import torch

from . import common

#: the facade returns −(pattern displacement) (the reference convention of
#: the generative model, as the pyramid's)
FLOW_SIGN = -1.0
NORM_EPS = 1e-4
#: the independent solver's own learning rate and decay (not the
#: ``optimizer`` section's): upstream's ``PatchEklt`` and the JAX package
LR, LR_DECAY = 0.01, 0.1
#: patches a block of the reference's solve
BLOCK = 1 << 16
#: active patches whose whole solve ``fit_gap`` and ``fit_share`` follow
FIT_SAMPLE = 1 << 14
#: a sampled patch is off (``fit_share``) when its refitted ``(vx, vy)``
#: lies farther from the reference's than this share of the sample's mean
#: ``|(vx, vy)|``
FIT_OFF = 0.1
#: the cost terms written here; ``image_gradient`` of a constant flow is 0
TERMS = ("diff_norm", "image_gradient", "flow_norm_pxy")


def _check(config: dict) -> None:
    """The reference writes out the configuration's model only."""
    s = config["solver"]
    g, pe = s["generative_ml"], s["patch_eklt"]
    unsupported = [k for k, v in (
        ("angle_model", g.get("angle_model", False)),
        ("no_polarity", g.get("no_polarity", False)),
        ("weight_loss_by_event_hist", g.get("weight_loss_by_event_hist",
                                            False)),
        ("use_log_intensity", g.get("use_log_intensity", False)),
        ("optimize_warp", not g.get("optimize_warp", False)),
        ("do_event_thresholding", pe.get("do_event_thresholding", False)),
        ("cost_with_weight", set(s["cost_with_weight"]) - set(TERMS)),
        ("optimizer", s["optimizer"].get("method", "Adam") != "Adam"),
    ) if v]
    if unsupported:
        raise ValueError(f"the patch reference does not write {unsupported}")


def grid(config: dict):
    """``(patch, stride, (gh, gw))`` of the configuration's grid."""
    pe = config["solver"]["patch_eklt"]
    p = int(pe["patch_size"])
    s = int(pe.get("sliding_window", p))
    return p, s, tuple(len(range(0, n - p + s, s))
                       for n in config["image_size"])


def active_box(config: dict):
    """``(rows, cols)``: the grid rows and columns whose centres lie in
    the ROI (a box of the grid, since the ROI is a box)."""
    p, s, shape = grid(config)
    x0, x1, y0, y1 = common.roi(config)
    out = []
    for n, lo, hi in zip(shape, (x0, y0), (x1, y1)):
        centre = np.arange(n) * s + p / 2
        out.append(np.flatnonzero((centre >= lo) & (centre <= hi)))
    return tuple(out)


def _starts(n_grid: int, size: int, p: int, s: int) -> np.ndarray:
    return np.minimum(np.arange(n_grid) * s, size - p)


def windows(image: torch.Tensor, config: dict, rows, cols) -> torch.Tensor:
    """The ``[len(rows)·len(cols), p, p]`` windows of ``image`` at the grid
    ``rows`` × ``cols``, row-major."""
    p, s, shape = grid(config)
    h, w = image.shape
    k = np.arange(p)
    ri = torch.as_tensor(_starts(shape[0], h, p, s)[rows][:, None] + k,
                         device=image.device)
    ci = torch.as_tensor(_starts(shape[1], w, p, s)[cols][:, None] + k,
                         device=image.device)
    win = image[ri[:, None, :, None], ci[None, :, None, :]]
    return win.reshape(-1, p, p)


def frame_constants(window, config: dict, device) -> Dict:
    """A window's measured increment and the frame's Sobel gradients, cut
    into the active patches' windows (float64)."""
    dtype = torch.float64
    h, w = config["image_size"]
    gml = config["solver"]["generative_ml"]
    ev = common.roi_events(window.events, config, dtype, device)
    hist = common.vote(ev[:, 0], ev[:, 1],
                       torch.where(ev[:, 3] > 0, 1.0, -1.0).to(dtype),
                       (h, w))[0]
    measured = common.blur(hist, float(gml["iwe_sigma"]), "reflect")
    frame = torch.as_tensor(window.frame).to(device=device, dtype=dtype)
    gx, gy = common.sobel(frame, "reflect")
    rows, cols = active_box(config)
    m = windows(measured, config, rows, cols)
    norm = torch.sqrt(torch.sum(m * m, dim=(1, 2)))
    return {"measured": m / torch.clamp(norm, min=1e-30)[:, None, None],
            "gx": windows(gx, config, rows, cols),
            "gy": windows(gy, config, rows, cols)}


def _shifted(img: torch.Tensor, px: torch.Tensor,
             py: torch.Tensor) -> torch.Tensor:
    """``out[n, r, c] = img[n]`` sampled bilinearly at ``(r − px[n], c −
    py[n])``, zero outside the window."""
    n, p = img.shape[0], img.shape[-1]
    k = torch.arange(p, dtype=img.dtype, device=img.device)
    rows = k[None, :] - px[:, None]
    cols = k[None, :] - py[:, None]
    r0, c0 = torch.floor(rows), torch.floor(cols)
    dr, dc = rows - r0, cols - c0
    batch = torch.arange(n, device=img.device)[:, None, None]
    out = 0.0
    for a, wr in ((0, 1 - dr), (1, dr)):
        for b, wc in ((0, 1 - dc), (1, dc)):
            rr, cc = r0 + a, c0 + b
            inside = (((rr >= 0) & (rr < p))[:, :, None]
                      & ((cc >= 0) & (cc < p))[:, None, :])
            tap = img[batch, rr.clamp(0, p - 1).long()[:, :, None],
                      cc.clamp(0, p - 1).long()[:, None, :]]
            out = out + torch.where(inside, tap * wr[:, :, None]
                                    * wc[:, None, :], 0.0)
    return out


def _safe_norm(sq: torch.Tensor) -> torch.Tensor:
    zero = sq == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))


def patch_losses(theta: torch.Tensor, consts: Dict, weights: Dict
                 ) -> torch.Tensor:
    """``[n]``: each patch's loss at its ``θ = (vx, vy, px, py)``."""
    vx, vy, px, py = theta.unbind(1)
    pred = (vx[:, None, None] * _shifted(consts["gx"], px, py)
            + vy[:, None, None] * _shifted(consts["gy"], px, py))
    norm = _safe_norm(torch.sum(pred * pred, dim=(1, 2)))
    pred = pred / (norm + NORM_EPS)[:, None, None]
    columns = torch.sum(common.abs_jax(pred - consts["measured"]), dim=1)
    terms = {"diff_norm": torch.amax(columns, dim=1),
             "image_gradient": torch.zeros_like(vx),
             "flow_norm_pxy": _safe_norm(px * px + py * py)}
    return sum(float(w) * terms[name] for name, w in weights.items())


def follow(consts: Dict, config: dict, steps: int):
    """Adam from 0 over the patches of ``consts``, block by block, for
    ``steps`` steps: ``(losses, best)``, each step's loss summed over the
    patches, and each patch's best iterate ``[n, 4]`` (the first of its
    least loss among the iterates evaluated)."""
    n_iter = int(config["solver"]["optimizer"]["n_iter"])
    weights = dict(config["solver"]["cost_with_weight"])
    lr = float(np.float32(LR))
    b1, b2, eps = common.ADAM_B1, common.ADAM_B2, common.ADAM_EPS
    n = consts["measured"].shape[0]
    total = torch.zeros(steps, dtype=torch.float64,
                        device=consts["measured"].device)
    best = []
    for lo in range(0, n, BLOCK):
        block = {k: v[lo:lo + BLOCK] for k, v in consts.items()}
        theta = torch.zeros((block["measured"].shape[0], 4),
                            dtype=torch.float64, device=block["gx"].device)
        mu = torch.zeros_like(theta)
        nu = torch.zeros_like(theta)
        best_theta = theta.clone()
        best_loss = torch.full(theta.shape[:1], math.inf,
                               dtype=torch.float64, device=theta.device)
        for k in range(steps):
            x = theta.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = patch_losses(x, block, weights)
                (g,) = torch.autograd.grad(loss.sum(), x)
            loss = loss.detach()
            total[k] += loss.sum()
            better = loss < best_loss
            best_theta = torch.where(better[:, None], theta, best_theta)
            best_loss = torch.where(better, loss, best_loss)
            c = k + 1
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * g * g + b2 * nu
            step_lr = lr * LR_DECAY ** (k // n_iter)
            theta = theta - step_lr * (mu / (1 - b1 ** c)) / (
                torch.sqrt(nu / (1 - b2 ** c)) + eps)
        best.append(best_theta)
    return total.cpu().numpy(), torch.cat(best)


def trajectories(windows: Sequence, solves: Sequence, config: dict,
                 seed: int, steps: int, device) -> Dict[int, np.ndarray]:
    """The first ``steps`` summed losses of each solve in ``solves``
    (``(solve_index, window_index)`` pairs), in float64; every solve of a
    window gets that window's."""
    _check(config)
    out = {}
    for wi in sorted({w for _s, w in solves}):
        consts = frame_constants(windows[wi], config, device)
        traj, _best = follow(consts, config, steps)
        del consts
        for s, w in solves:
            if w == wi:
                out[s] = traj.copy()
    return out


def schedule_faults(losses, config: dict) -> int:
    """Histories missing or added (one a solve), and a history of
    another length than ``n_iter`` or with a loss that is not finite."""
    n_iter = int(config["solver"]["optimizer"]["n_iter"])
    faults = abs(len(losses) - 1)
    for got in losses[:1]:
        got = np.asarray(got)
        faults += int(got.shape != (n_iter,) or not np.all(np.isfinite(got)))
    return faults


@functools.lru_cache(maxsize=4)
def _operators(image_size, patch: int, stride: int, shape, box):
    """``(mh, mw_t)`` restricted to the active box: the float64 matrices
    with ``dense = mh @ field[rows, cols] @ mw_t`` for a field that is zero
    off the box's ``rows`` × ``cols``."""
    out = []
    for n, size, idx in zip(shape, image_size, box):
        pad = int(patch / 2 // stride) + 1
        up = (n + 2 * pad) * stride
        start = up // 2 - size // 2
        edge = np.zeros((n + 2 * pad, n))
        edge[np.arange(n + 2 * pad),
             np.clip(np.arange(-pad, n + pad), 0, n - 1)] = 1.0
        full = common.resize_matrix(n + 2 * pad, up)[start + np.arange(size)]
        out.append((full @ edge)[:, np.asarray(idx)])
    mh, mw = out
    return mh, np.ascontiguousarray(mw.T)


def operators(config: dict):
    p, s, shape = grid(config)
    box = tuple(tuple(int(i) for i in a) for a in active_box(config))
    return _operators(tuple(config["image_size"]), p, s, shape, box)


def dense_flow(best: torch.Tensor, config: dict) -> torch.Tensor:
    """The ``[2, H, W]`` flow of the active patches' ``(vx, vy)``
    (``best``, row-major over the active box)."""
    rows, cols = active_box(config)
    mh, mw_t = (torch.as_tensor(m).to(best.device) for m in operators(config))
    field = best[:, :2].T.reshape(2, len(rows), len(cols))
    return mh @ field @ mw_t


def _projector(m: torch.Tensor) -> torch.Tensor:
    """The orthogonal projector onto the column space of ``m``."""
    u, sv, _vh = torch.linalg.svd(m, full_matrices=False)
    u = u[:, sv > sv[0] * 1e-10]
    return u @ u.T


def fit_sample(config: dict, seed: int) -> np.ndarray:
    """The active patches (indices, row-major over the active box) whose
    whole solve ``fit_gap`` follows: :data:`FIT_SAMPLE` drawn from the
    seed, or all of them."""
    rows, cols = active_box(config)
    n = len(rows) * len(cols)
    if n <= FIT_SAMPLE:
        return np.arange(n)
    rng = np.random.default_rng(int(seed))
    return np.sort(rng.choice(n, FIT_SAMPLE, replace=False))


def field_checks(frames: Sequence, windows: Sequence, config: dict,
                 seed: int, device) -> Dict[str, float]:
    """The returned flows against the patch→dense operator and against
    the reference's whole solve:

    - ``flow_gap``: over every frame, the largest residual of the flow
      refitted (least squares, float64) onto the active patches through
      the operator, over the flow's largest value (0 for a zero flow);
    - ``fit_gap``: over every frame, the median over a sample of active
      patches (:func:`fit_sample`) of the distance between the refitted
      ``(vx, vy)`` and the best iterate of the reference's ``n_iter``
      steps, over the mean size of the latter: how closely the typical
      patch follows, which the precision of the solve and of the
      assembly sets;
    - ``fit_share``: over every frame, the share of those patches that
      are off by more than :data:`FIT_OFF` of that mean size: a fault at
      a minority of the patches, which the median passes over.  A sound
      float32 solve parts that far from the float64 one at a few patches
      in ten thousand: those whose loss differs from the first step on (a
      prediction that cancels, a near-tie of the largest columns) and
      those whose best iterate comes late, after hundreds of steps of
      slow descent along which the two precisions drift apart.

    The mean size sets the scale, not each patch's own: the best iterate
    of a patch that no step improves is its start, a velocity of exactly
    0, and a distance over that is unbounded for any rounding at all.

    Each is inf where a flow is not finite."""
    mh, mw_t = (torch.as_tensor(m).to(device) for m in operators(config))
    ph, pw = _projector(mh), _projector(mw_t.T)
    pinv_h, pinv_w = torch.linalg.pinv(mh), torch.linalg.pinv(mw_t)
    n_iter = int(config["solver"]["optimizer"]["n_iter"])
    sample = torch.as_tensor(fit_sample(config, seed), device=device)
    fits = {}
    out = {"flow_gap": 0.0, "fit_gap": 0.0, "fit_share": 0.0}
    for f in frames:
        flow = torch.as_tensor(np.asarray(f.flow)).to(device=device,
                                                      dtype=torch.float64)
        if not bool(torch.all(torch.isfinite(flow))):
            return {k: math.inf for k in out}
        top = float(torch.amax(torch.abs(flow)))
        if top > 0:
            residual = flow - ph @ flow @ pw
            out["flow_gap"] = max(out["flow_gap"], float(
                torch.amax(torch.abs(residual))) / top)
        if f.window not in fits:
            consts = frame_constants(windows[f.window], config, device)
            _losses, best = follow({k: v[sample] for k, v in consts.items()},
                                   config, n_iter)
            fits[f.window] = best[:, :2]
        want = fits[f.window]
        got = (pinv_h @ flow @ pinv_w).reshape(2, -1).T[sample]
        off = (torch.linalg.norm(got - want, dim=1)
               / torch.mean(torch.linalg.norm(want, dim=1)))
        out["fit_gap"] = max(out["fit_gap"], float(torch.median(off)))
        out["fit_share"] = max(out["fit_share"], float(
            torch.mean((off > FIT_OFF).to(torch.float64))))
    return out


def assembly_faults(flow: np.ndarray, config: dict) -> int:
    """Pixels that no active patch reaches and that are not exactly +0.0,
    and non-finite pixels."""
    mh, mw_t = operators(config)
    reached = ((np.abs(mh).sum(axis=1) > 0)[:, None]
               & (np.abs(mw_t).sum(axis=0) > 0)[None, :])
    bits = np.asarray(flow, np.float32).view(np.uint32)
    return int(np.count_nonzero(bits[:, ~reached])
               + np.count_nonzero(~np.isfinite(flow[:, reached])))
