"""The fast-plume BOS scene: consecutive windows of one simulated sequence.

A frozen copy of the port's ``data/synthetic.py`` (``make_background``,
``displacement_field``, ``render_frame`` and the event emission of
``generate_sequence``), so that the benchmark's inputs stay the same
whatever the program later does to its own generator.  A textured
background is pushed by a rising Gaussian plume; the brightness change
between consecutive frames emits events at integer pixel positions, with
the polarity of the change (5 % flipped).  Window ``i`` holds the events
between frames ``i`` and ``i + 1``; its model frame is frame ``i + 1`` and
its true flow the pattern displacement between the two, as in
``bench.py::make_workload``.

Parameters (the traffic file's ``scene_params``): ``fps``,
``plume_speed`` (px/s), ``max_displacement`` (px), ``pattern_scale``
(speckle size, px) and ``t_offset`` (s added to every timestamp).
"""

from __future__ import annotations

from typing import List

import numpy as np

from . import Window


def _background(h: int, w: int, scale: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // scale + 2, w // scale + 2))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    img = ((1 - fy) * (1 - fx) * coarse[np.ix_(y0, x0)]
           + fy * (1 - fx) * coarse[np.ix_(y0 + 1, x0)]
           + (1 - fy) * fx * coarse[np.ix_(y0, x0 + 1)]
           + fy * fx * coarse[np.ix_(y0 + 1, x0 + 1)])
    return img.astype(np.float64)


def _displacement(h: int, w: int, speed: float, peak: float,
                  t: float) -> np.ndarray:
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy = h * 0.75 - speed * t
    cx = w * 0.5 + 0.08 * w * np.sin(2 * np.pi * t)
    sig = 0.18 * min(h, w)
    g = np.exp(-(((gy - cy) ** 2) + ((gx - cx) ** 2)) / (2 * sig**2))
    return np.stack([-peak * g, 0.4 * peak * g * np.sin(4 * np.pi * t)])


def _render(background: np.ndarray, disp: np.ndarray) -> np.ndarray:
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


def sequence(h: int, w: int, n_windows: int, n_events: int, params: dict,
             seed: int):
    """``(frames [n+1, H, W], displacements [n+1, 2, H, W], events)``:
    ``events`` is a list of ``n_windows`` arrays ``(n_events, 4)`` of
    ``(row, col, t, p)``, each sorted by ``t``, before ``t_offset``."""
    rng = np.random.default_rng(seed + 1)
    bg = _background(h, w, int(params["pattern_scale"]), seed)
    fps = float(params["fps"])
    ts = np.arange(n_windows + 1) / fps
    frames = np.empty((n_windows + 1, h, w))
    disps = np.empty((n_windows + 1, 2, h, w))
    for i, t in enumerate(ts):
        disps[i] = _displacement(h, w, float(params["plume_speed"]),
                                 float(params["max_displacement"]), t)
        frames[i] = _render(bg, disps[i])
    events = []
    for i in range(n_windows):
        dl = frames[i + 1] - frames[i]
        mag = np.abs(dl)
        prob = mag / (mag.sum() + 1e-12)
        idx = rng.choice(h * w, size=n_events, p=prob.reshape(-1))
        t_ev = rng.uniform(ts[i], ts[i + 1], n_events)
        pol = np.sign(dl.reshape(-1)[idx])
        flip = rng.uniform(size=n_events) < 0.05
        pol = np.where(flip, -pol, pol)
        pol = np.where(pol == 0, 1.0, pol)
        ev = np.stack([(idx // w).astype(np.float64),
                       (idx % w).astype(np.float64), t_ev, pol], axis=1)
        events.append(ev[np.argsort(ev[:, 2], kind="stable")])
    return frames, disps, events


def make_windows(image_size, n_windows: int, n_events: int, params: dict,
                 seed: int) -> List[Window]:
    h, w = image_size
    frames, disps, events = sequence(h, w, n_windows, n_events, params, seed)
    out = []
    for i, ev in enumerate(events):
        ev[:, 2] += float(params.get("t_offset", 0.0))
        out.append(Window(events=ev,
                          frame=frames[i + 1].astype(np.float32),
                          true_flow=(disps[i + 1] - disps[i]).astype(
                              np.float32)))
    return out
