"""Synthetic event-based BOS sequence generator.

The reference assumes a recorded CCS dataset (Prophesee events + Basler
frames); none ships with the repo.  For tests, benchmarks and demos this
module simulates the *physics the solver inverts*: a textured background
pattern is distorted by a smooth time-varying displacement field (the
Schlieren effect), the induced brightness change emits events according to
the linearized generative model ``ΔL ≈ −∇I·u`` (the same model the solver
fits, ``generative_max_likelihood.py:459-487``), and the distorted frames are
rendered for the frame-camera path (Farnebäck GT).

Everything is numpy on the host (data generation is not the accelerated
path).  This is the port's own copy of the JAX package's
``data/synthetic.py``, so that the port builds the same workloads on a
machine without JAX; the same config and seed give the same arrays.
"""

from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["SyntheticBosConfig", "make_background", "displacement_field",
           "render_frame", "generate_sequence"]


@dataclasses.dataclass
class SyntheticBosConfig:
    height: int = 240
    width: int = 320
    duration: float = 1.0          # seconds
    fps: float = 60.0              # frame camera rate
    events_per_frame: int = 40_000
    plume_speed: float = 40.0      # px/s upward drift of the hot plume
    max_displacement: float = 2.0  # peak pattern displacement (px)
    pattern_scale: int = 3         # speckle size
    seed: int = 0


def make_background(cfg: SyntheticBosConfig) -> np.ndarray:
    """Random speckle background (the BOS target pattern), uint8 range."""
    rng = np.random.default_rng(cfg.seed)
    coarse = rng.uniform(0, 255, (cfg.height // cfg.pattern_scale + 2,
                                  cfg.width // cfg.pattern_scale + 2))
    # bilinear upsample to full res → smooth speckle with strong gradients
    ys = np.linspace(0, coarse.shape[0] - 1.001, cfg.height)
    xs = np.linspace(0, coarse.shape[1] - 1.001, cfg.width)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    img = ((1 - fy) * (1 - fx) * coarse[np.ix_(y0, x0)]
           + fy * (1 - fx) * coarse[np.ix_(y0 + 1, x0)]
           + (1 - fy) * fx * coarse[np.ix_(y0, x0 + 1)]
           + fy * fx * coarse[np.ix_(y0 + 1, x0 + 1)])
    return img.astype(np.float64)


def displacement_field(cfg: SyntheticBosConfig, t: float) -> np.ndarray:
    """Smooth "hot plume" displacement u(x, t): a rising Gaussian blob.

    Returns ``[2, H, W]`` (row, col) pattern displacement in pixels.
    """
    h, w = cfg.height, cfg.width
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    # blob center drifts upward (decreasing row) and wobbles in column
    cy = h * 0.75 - cfg.plume_speed * t
    cx = w * 0.5 + 0.08 * w * np.sin(2 * np.pi * t)
    sig = 0.18 * min(h, w)
    g = np.exp(-(((gy - cy) ** 2) + ((gx - cx) ** 2)) / (2 * sig**2))
    u_row = -cfg.max_displacement * g          # pattern appears pushed up
    u_col = 0.4 * cfg.max_displacement * g * np.sin(4 * np.pi * t)
    return np.stack([u_row, u_col])


def render_frame(background: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """Render the distorted view: ``I_t(x) = I0(x − u(x, t))`` (bilinear)."""
    h, w = background.shape
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    sy = np.clip(gy - disp[0], 0, h - 1)
    sx = np.clip(gx - disp[1], 0, w - 1)
    y0 = np.floor(sy).astype(int)
    x0 = np.floor(sx).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = sy - y0
    fx = sx - x0
    return ((1 - fy) * (1 - fx) * background[y0, x0]
            + fy * (1 - fx) * background[y1, x0]
            + (1 - fy) * fx * background[y0, x1]
            + fy * fx * background[y1, x1])


def generate_sequence(cfg: SyntheticBosConfig):
    """Simulate the full recording.

    Returns dict with:
      * ``background`` ``[H, W]`` float64 pattern.
      * ``frames`` ``[n_frames, H, W]`` distorted views.
      * ``frame_ts`` ``[n_frames]`` timestamps (s).
      * ``events`` ``(n, 4)`` float64 ``(x=row, y=col, t, p∈{−1,1})`` sorted by t.
      * ``gt_flow`` ``[n_frames-1, 2, H, W]`` inter-frame pattern displacement
        (the quantity the solver estimates; reference evaluates against
        Farnebäck between frames, ``bos_event.py:155-157``).
    """
    rng = np.random.default_rng(cfg.seed + 1)
    bg = make_background(cfg)
    n_frames = int(cfg.duration * cfg.fps) + 1
    frame_ts = np.arange(n_frames) / cfg.fps

    frames = np.empty((n_frames, cfg.height, cfg.width))
    disps = np.empty((n_frames, 2, cfg.height, cfg.width))
    for i, t in enumerate(frame_ts):
        disps[i] = displacement_field(cfg, t)
        frames[i] = render_frame(bg, disps[i])

    gt_flow = disps[1:] - disps[:-1]

    # Events between consecutive frames: the linearized brightness change
    # dL = I_{i+1} − I_i ≈ −∇I·du fires events with rate ∝ |dL|.
    xs, ys, ts, ps = [], [], [], []
    for i in range(n_frames - 1):
        dl = frames[i + 1] - frames[i]
        mag = np.abs(dl)
        prob = mag / (mag.sum() + 1e-12)
        idx = rng.choice(cfg.height * cfg.width, size=cfg.events_per_frame,
                         p=prob.reshape(-1))
        r = idx // cfg.width
        c = idx % cfg.width
        t0, t1 = frame_ts[i], frame_ts[i + 1]
        t_ev = rng.uniform(t0, t1, cfg.events_per_frame)
        # polarity from the sign of the brightness change (+ sensor noise)
        pol = np.sign(dl.reshape(-1)[idx])
        flip = rng.uniform(size=cfg.events_per_frame) < 0.05
        pol = np.where(flip, -pol, pol)
        pol = np.where(pol == 0, 1.0, pol)
        xs.append(r.astype(np.float64))
        ys.append(c.astype(np.float64))
        ts.append(t_ev)
        ps.append(pol)

    events = np.stack([np.concatenate(xs), np.concatenate(ys),
                       np.concatenate(ts), np.concatenate(ps)], axis=1)
    events = events[np.argsort(events[:, 2], kind="stable")]
    return {
        "background": bg,
        "frames": frames,
        "frame_ts": frame_ts,
        "events": events,
        "gt_flow": gt_flow,
        "config": cfg,
    }
