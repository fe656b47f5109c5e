"""Sharded pipeline stages: event-axis vote reduction and data-parallel
solves over a :class:`~.mesh.Mesh` of ranks.

PyTorch counterpart of the JAX package's ``parallel/sharding.py``.  Each
rank votes its ``N/E`` slice of the events of its data lane's frames into
``[2, H, W]`` polarity planes (one launch of the vote kernel a frame on
the card) and the planes are summed over the ``event`` group.  The rank at
``event = 0`` of each data lane (the lane's leader) then solves the lane's
frames with the same operations as the pyramid facade (the IWE cache from
the votes, the frame gradients, :func:`..solver.pyramid.solve_pyramid`)
and broadcasts the results, so every rank returns them.  On integer
coordinates every vote is an integer count and the sums are exact, so a
step equals the single-process solves from the same inits bit for bit.

Where JAX's steps take PRNG keys, these take the coarsest-scale inits
(the caller draws them, :func:`..solver.generative.initialize_params`, in
frame order; every rank must pass the same ones).  ``record_evolution`` is
turned off with a warning (nothing consumes per-iterate parameters here);
``fetch_dtype`` casts the returned flows.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.gradients import frame_gradients
from ..solver.generative import (GenerativeSpec, iwe_cache_from_votes,
                                 polarity_votes)
from ..solver.pyramid import (PyramidSpec, restart_scores, scale_iterations,
                              solve_pyramid, update_coarse_from_fine)
from ..types import Events
from .mesh import Mesh, all_reduce_, broadcast_

logger = logging.getLogger(__name__)

__all__ = ["sharded_polarity_votes", "make_multichip_estimator",
           "make_multichip_multistart", "make_multichip_sequential"]


def _lane_split(mesh: Mesh, n: int, data_axis: Optional[str], what: str):
    """``(lane index, items a lane)`` of ``n`` items over the data axis."""
    d_size = mesh.axis_size(data_axis)
    if n % d_size:
        raise ValueError(f"{what} ({n}) must be divisible by the mesh data "
                         f"axis ({d_size})")
    return mesh.index(data_axis), n // d_size


def _shard_votes(ev: Events, frames: Sequence[int], spec: GenerativeSpec,
                 mesh: Mesh, event_axis: str) -> torch.Tensor:
    """This rank's event slice of frames ``frames`` of ``ev`` (``[B, N]``)
    voted into ``[len(frames), 2, H, W]`` planes, summed over the event
    group, on the rank's device in ``spec.dtype``."""
    n = ev.x.shape[-1]
    e_size = mesh.axis_size(event_axis)
    if n % e_size:
        raise ValueError(f"the event capacity ({n}) must be divisible by the "
                         f"mesh event axis ({e_size})")
    shard = n // e_size
    lo = mesh.index(event_axis) * shard
    planes = [polarity_votes(Events(*(f[b, lo:lo + shard].to(mesh.device)
                                      for f in ev)), spec)
              for b in frames]
    return all_reduce_(torch.stack(planes), mesh, event_axis)


def _gather_lanes(local: Optional[torch.Tensor], mesh: Mesh,
                  data_axis: Optional[str], shape, dtype) -> torch.Tensor:
    """``[B, *shape]`` on every rank from each lane leader's ``[B/D,
    *shape]`` (``local``; None on the other ranks), one broadcast a lane."""
    d_size = mesh.axis_size(data_axis)
    out = torch.empty(shape, dtype=dtype, device=mesh.device)
    lanes = out.shape[0] // d_size
    if local is not None:
        d = mesh.index(data_axis)
        out[d * lanes:(d + 1) * lanes] = local
    for d in range(d_size):
        src = mesh.global_rank(**{data_axis: d, "event": 0}) if data_axis \
            else 0
        broadcast_(out[d * lanes:(d + 1) * lanes], mesh, src)
    return out


def sharded_polarity_votes(ev: Events, spec: GenerativeSpec, mesh: Mesh,
                           event_axis: str = "event",
                           data_axis: Optional[str] = "data"
                           ) -> torch.Tensor:
    """Polarity vote planes with the events sharded over ``event_axis``.

    ``ev`` fields are ``[B, N]``: each rank votes the ``N/E`` slice of its
    data lane's ``B/D`` frames (all ``B`` with ``data_axis=None``), the
    planes are summed over the event group and gathered over the data
    lanes.  Returns ``[B, 2, H, W]`` in ``spec.dtype`` on every rank.
    """
    b = ev.x.shape[0]
    if data_axis is None or mesh.axis_size(data_axis) == 1:
        return _shard_votes(ev, range(b), spec, mesh, event_axis)
    d, lanes = _lane_split(mesh, b, data_axis, "the batch")
    local = _shard_votes(ev, range(d * lanes, (d + 1) * lanes), spec, mesh,
                         event_axis)
    return _gather_lanes(local, mesh, data_axis,
                         (b, 2) + tuple(spec.image_size), spec.dtype)


def _no_recording(spec: PyramidSpec, what: str) -> PyramidSpec:
    if spec.record_evolution > 0:
        logger.warning(
            "record_evolution is not supported by the %s; disabling "
            "recording for this estimator.", what)
        spec = dataclasses.replace(spec, record_evolution=0)
    return spec


def _frame_constants(pol, frame, mask, gen: GenerativeSpec, device):
    """The solve's constants of one frame on ``device``, as the pyramid
    facade makes them: the IWE cache from the votes, the frame's
    gradients and the mask."""
    hist, weights, weight_inverse = iwe_cache_from_votes(pol, gen)
    frame = torch.as_tensor(frame).to(device=device, dtype=gen.dtype)
    gx, gy = frame_gradients(frame, ksize=gen.sobel_ksize,
                             use_log_intensity=gen.use_log_intensity)
    mask = torch.as_tensor(mask).to(device=device, dtype=gen.dtype)
    return hist, weights, weight_inverse, gx, gy, mask


def _on(a, mesh: Mesh, dtype):
    return torch.as_tensor(a).to(device=mesh.device, dtype=dtype)


class _Packer:
    """Flatten a lane's ``(flow [2, H, W], per-scale histories)`` into one
    row (one broadcast a lane) and back, in the solve's dtype."""

    def __init__(self, spec: PyramidSpec):
        self.image = (2,) + tuple(spec.gen.image_size)
        self.iters = scale_iterations(spec)

    @property
    def width(self) -> int:
        return int(np.prod(self.image)) + sum(self.iters)

    def pack(self, flow, hists) -> torch.Tensor:
        return torch.cat([flow.reshape(-1)] + list(hists))

    def unpack(self, rows: torch.Tensor):
        n = int(np.prod(self.image))
        flows = rows[:, :n].reshape((rows.shape[0],) + self.image)
        hists, at = [], n
        for k in self.iters:
            hists.append(rows[:, at:at + k])
            at += k
        return flows, tuple(hists)


def _finish(rows, packer: _Packer, fetch_dtype):
    flows, hists = packer.unpack(rows)
    if fetch_dtype is not None:
        flows = flows.to(fetch_dtype)
    return flows, hists


def make_multichip_estimator(spec: PyramidSpec, mesh: Mesh,
                             fetch_dtype=None):
    """The data-parallel step for a batch of frames.

    Returns ``step(ev, frames, mask, inits) -> (flows [B, 2, H, W],
    per-scale histories)``: ``ev`` fields ``[B, N]``, ``frames [B, H, W]``,
    the ROI ``mask``, ``inits [B, dim, gh, gw]`` (each frame's coarsest
    start); the histories are a tuple of ``[B, n_iter_s]`` tensors,
    coarsest → finest.  ``B`` must be a multiple of the data axis.
    """
    spec = _no_recording(spec, "multi-chip batched step")
    gen = spec.gen
    packer = _Packer(spec)

    def step(ev: Events, frames, mask, inits):
        b = ev.x.shape[0]
        d, lanes = _lane_split(mesh, b, "data", "the batch")
        mine = range(d * lanes, (d + 1) * lanes)
        pol = _shard_votes(ev, mine, spec.gen, mesh, "event")
        rows = None
        if mesh.index("event") == 0:
            out = []
            for i, f in enumerate(mine):
                c = _frame_constants(pol[i], frames[f], mask, gen,
                                     mesh.device)
                flow, aux = solve_pyramid(*c, None, spec, init_params=_on(
                    inits[f], mesh, gen.dtype))
                out.append(packer.pack(flow, aux["loss_history"]))
            rows = torch.stack(out)
        rows = _gather_lanes(rows, mesh, "data", (b, packer.width),
                             gen.dtype)
        return _finish(rows, packer, fetch_dtype)

    return step


def make_multichip_multistart(spec: PyramidSpec, mesh: Mesh,
                              fetch_dtype=None):
    """Multi-start pyramid solve with the ``R = spec.n_restarts`` restarts
    split over the data axis (``R/D`` a lane) and the events of the one
    frame over the event axis.

    Returns ``step(ev [1, N], frames [1, H, W], mask, inits [R, dim, gh,
    gw]) -> (flow [1, 2, H, W], per-scale histories [1, n_iter_s])`` of the
    winning restart, picked as the single-process multi-start picks it
    (``solver.pyramid.select_restart``): the least finest-scale loss under
    ``track_best``, else the final one, the first restart on ties.
    """
    r_count = spec.n_restarts
    if r_count < 2:
        raise ValueError("make_multichip_multistart needs n_restarts > 1")
    spec = _no_recording(spec, "mesh multi-start step")
    d_size = mesh.axis_size("data")
    if r_count % d_size:
        raise ValueError(
            f"n_restarts ({r_count}) must be divisible by the mesh data axis "
            f"({d_size}) to shard the restart lanes evenly")
    gen = spec.gen
    packer = _Packer(spec)
    per_lane = r_count // d_size

    def step(ev: Events, frames, mask, inits):
        pol = _shard_votes(ev, range(1), gen, mesh, "event")[0]
        d = mesh.index("data")
        mine = range(d * per_lane, (d + 1) * per_lane)
        lanes = scores = None
        if mesh.index("event") == 0:
            c = _frame_constants(pol, frames[0], mask, gen, mesh.device)
            lanes = [solve_pyramid(*c, None, spec, init_params=_on(
                inits[r], mesh, gen.dtype)) for r in mine]
            scores = restart_scores(lanes, spec.track_best)
        scores = _gather_lanes(scores, mesh, "data", (r_count,), gen.dtype)
        best = int(torch.argmin(scores))
        owner = best // per_lane
        rows = torch.empty((1, packer.width), dtype=gen.dtype,
                           device=mesh.device)
        if lanes is not None and owner == d:
            flow, aux = lanes[best - d * per_lane]
            rows[0] = packer.pack(flow, aux["loss_history"])
        broadcast_(rows, mesh, mesh.global_rank(data=owner, event=0))
        return _finish(rows, packer, fetch_dtype)

    return step


def make_multichip_sequential(spec: PyramidSpec, mesh: Mesh,
                              steady_spec: Optional[PyramidSpec] = None,
                              fetch_dtype=None):
    """Data-parallel warm-started sequences: one warm-start chain a data
    lane, advancing in lockstep (step *t* solves frame *t* of every lane).

    Returns ``(step_cold, step_warm)``:

    * ``step_cold(ev [D, N], frames [D, H, W], mask, inits [D, dim, gh,
      gw]) -> (flows, prev, losses)``: every lane starts cold at ``spec``;
    * ``step_warm(ev, frames, mask, prev, carry_valid [D]) -> (flows,
      prev', losses)``: the lanes run ``steady_spec`` (or ``spec``) from
      ``prev``; a lane whose ``carry_valid`` is False keeps its incoming
      ``prev`` bit for bit (a dummy frame must not enter the chain).

    ``prev`` is the coarse-from-fine feedback of this rank's lanes, a list
    over scales of ``[D/D_mesh, dim, gh, gw]`` tensors on the lane
    leader's device, and None on the other ranks; it never leaves the
    device.
    """
    if spec.n_restarts > 1:
        raise ValueError("sequential mesh mode is warm-start based; "
                         "n_restarts > 1 is a cold-start feature "
                         "(see the facade's warm_start validation)")
    cold = _no_recording(spec, "mesh sequential step")
    warm = _no_recording(steady_spec or spec, "mesh sequential step")
    gen = spec.gen
    packer = _Packer(cold)
    packer_warm = _Packer(warm)

    def solve_lanes(ev, frames, mask, s, pk, inits=None, prev=None,
                    carry_valid=None):
        b = ev.x.shape[0]
        d, lanes = _lane_split(mesh, b, "data", "the lane count")
        mine = range(d * lanes, (d + 1) * lanes)
        pol = _shard_votes(ev, mine, gen, mesh, "event")
        rows = nxt = None
        if mesh.index("event") == 0:
            out, feedback = [], []
            for i, f in enumerate(mine):
                c = _frame_constants(pol[i], frames[f], mask, gen,
                                     mesh.device)
                if prev is None:
                    flow, aux = solve_pyramid(*c, None, s, init_params=_on(
                        inits[f], mesh, gen.dtype))
                else:
                    flow, aux = solve_pyramid(
                        *c, None, s, prev_params=[p[i] for p in prev])
                out.append(pk.pack(flow, aux["loss_history"]))
                new = update_coarse_from_fine(aux["params_per_scale"], s)
                if carry_valid is not None and not bool(carry_valid[f]):
                    new = [p[i] for p in prev]
                feedback.append(new)
            rows = torch.stack(out)
            nxt = [torch.stack(level) for level in zip(*feedback)]
        rows = _gather_lanes(rows, mesh, "data", (b, pk.width), gen.dtype)
        flows, losses = _finish(rows, pk, fetch_dtype)
        return flows, nxt, losses

    def step_cold(ev: Events, frames, mask, inits):
        return solve_lanes(ev, frames, mask, cold, packer, inits=inits)

    def step_warm(ev: Events, frames, mask, prev: Optional[List[torch.Tensor]],
                  carry_valid):
        return solve_lanes(ev, frames, mask, warm, packer_warm, prev=prev,
                           carry_valid=carry_valid)

    return step_cold, step_warm
