"""Batched hyper-parameter sweeps over the mesh's data axis.

PyTorch counterpart of the JAX package's ``parallel/sweep.py``: the lanes
of a sweep (learning rate × init) share one frame's IWE cache and
gradients, built once, and are split over the ``data`` axis; each lane is
one :func:`..solver.pyramid.solve_pyramid` at its rate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.gradients import frame_gradients
from ..solver.generative import iwe_cache
from ..solver.pyramid import PyramidSpec, solve_pyramid
from ..types import Events
from .mesh import Mesh
from .sharding import _gather_lanes, _lane_split

__all__ = ["hyperparam_sweep", "stack_events"]


def stack_events(event_batches: Sequence[Events]) -> Events:
    """Stack equal-capacity :class:`Events` into a leading batch axis."""
    return Events(*(torch.stack([getattr(e, f) for e in event_batches])
                    for f in Events._fields))


def hyperparam_sweep(ev: Events, frame, mask, lrs, inits, spec: PyramidSpec,
                     mesh: Optional[Mesh] = None):
    """Sweep (learning rate × init) for one frame.

    ``lrs`` holds ``S`` learning rates (each rounded to float32, as optax
    holds a rate) and ``inits`` the ``S`` coarsest-scale starts ``[S, dim,
    gh, gw]``.  The events, frame and mask live on the device the sweep
    runs on (the mesh rank's device with a mesh).  Returns ``(flows [S, 2,
    H, W], final_losses [S])``; with a mesh the lanes run ``S/D`` to a
    data lane (on its ``event = 0`` rank) and every rank returns all of
    them.
    """
    gen = spec.gen
    s_count = len(lrs)
    if mesh is None:
        mine, device = range(s_count), ev.x.device
    else:
        d, per_lane = _lane_split(mesh, s_count, "data", "the sweep size")
        mine, device = range(d * per_lane, (d + 1) * per_lane), mesh.device
    rows = None
    if mesh is None or mesh.index("event") == 0:
        ev = Events(*(f.to(device) for f in ev))
        frame = torch.as_tensor(frame).to(device=device, dtype=gen.dtype)
        gx, gy = frame_gradients(frame, ksize=gen.sobel_ksize,
                                 use_log_intensity=gen.use_log_intensity)
        hist, weights, weight_inverse = iwe_cache(ev, gen)
        mask = torch.as_tensor(mask).to(device=device, dtype=gen.dtype)
        out = []
        for i in mine:
            flow, aux = solve_pyramid(
                hist, weights, weight_inverse, gx, gy, mask, None, spec,
                init_params=torch.as_tensor(inits[i]).to(device=device,
                                                         dtype=gen.dtype),
                lr=float(np.float32(lrs[i])))
            out.append(torch.cat([flow.reshape(-1),
                                  aux["loss_history"][-1][-1:]]))
        rows = torch.stack(out)
    if mesh is not None:
        rows = _gather_lanes(rows, mesh, "data",
                             (s_count, 2 * int(np.prod(gen.image_size)) + 1),
                             gen.dtype)
    flows = rows[:, :-1].reshape((s_count, 2) + tuple(gen.image_size))
    return flows, rows[:, -1]
