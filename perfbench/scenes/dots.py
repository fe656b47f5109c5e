"""A rigidly translating dot pattern, one motion a window.

A frozen copy of ``chip_smoke.py::moving_dot_events``, with the positions
rounded to integer pixels as a sensor gives them (so the vote's float32
sums are exact and a frame repeats bit for bit).  Each window moves the
dots by one motion ``(v_row, v_col)`` px over the window; the CMax flow
that sharpens it is that motion, everywhere.

Every seed gets the same set of motions (the traffic file's
``scene_params.motions``), so that each run does the same work and reads
the same accuracy: the seed draws their order, a sign for each component,
the dots' places, times and jitter.  ``jitter`` is the standard deviation
(px) of each event's position around its dot's path; ``extent`` (rows and
columns ``[r0, r1, c0, c1]``, the whole frame by default) bounds the
pattern, so that a configuration's ROI crop keeps every event.
"""

from __future__ import annotations

from typing import List

import numpy as np

from . import Window


def dot_events(extent, vx: float, vy: float, n: int,
               rng: np.random.Generator, jitter: float) -> np.ndarray:
    r0, r1, c0, c1 = extent
    t = np.sort(rng.uniform(0, 1, n))
    x0 = rng.choice(np.arange(r0 + 6, r1 - 14, 4), n).astype(float)
    y0 = rng.choice(np.arange(c0 + 6, c1 - 14, 5), n).astype(float)
    x = x0 + vx * t + rng.normal(0, jitter, n)
    y = y0 + vy * t + rng.normal(0, jitter, n)
    return np.stack([np.round(x), np.round(y), t, np.ones(n)], 1)


def make_windows(image_size, n_windows: int, n_events: int, params: dict,
                 seed: int) -> List[Window]:
    h, w = image_size
    rng = np.random.default_rng(seed)
    motions = np.asarray(params["motions"], np.float64)
    order = rng.permutation(len(motions))
    out = []
    for i in range(n_windows):
        v = motions[order[i % len(motions)]] * rng.choice([-1.0, 1.0], 2)
        ev = dot_events(params.get("extent", (0, h, 0, w)), v[0], v[1],
                        n_events, rng, float(params["jitter"]))
        true_flow = np.broadcast_to(v.astype(np.float32)[:, None, None],
                                    (2, h, w)).copy()
        out.append(Window(events=ev, frame=None, true_flow=true_flow))
    return out
