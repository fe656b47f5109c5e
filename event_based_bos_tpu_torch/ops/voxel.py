"""Event voxel grids: the DSEC trilinear voxel and the EventGAN volume.

PyTorch counterpart of the JAX package's ``ops/voxel.py``: masked
scatter-adds over the fixed-capacity batch (``index_add_``), always into
float32 as there.  On the card the adds are atomics, so their order, and
the last bits of a cell fed by several events, may differ from run to run.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..types import Events
from .events import pixel_indices

__all__ = ["create_event_voxel", "generate_discretized_event_volume"]


def _live_range(ev: Events):
    tmin = torch.amin(torch.where(ev.valid, ev.t, torch.inf))
    tmax = torch.amax(torch.where(ev.valid, ev.t, -torch.inf))
    return tmin, tmax


def create_event_voxel(ev: Events, voxel_shape: Tuple[int, int, int],
                       normalize: bool = False) -> torch.Tensor:
    """Polarity-weighted trilinear voxel grid ``[C, H, W]`` (the DSEC
    representation): live times scaled to ``[0, C − 1]``, each event's
    polarity (expected in {−1, +1}) spread over its 8 neighbouring cells
    ``[c, x, y]``.  ``normalize`` standardizes the nonzero cells."""
    c, h, w = voxel_shape
    tmin, tmax = _live_range(ev)
    t_norm = (c - 1) * (ev.t - tmin) / torch.clamp(tmax - tmin, min=1e-30)
    x0 = torch.floor(ev.y)  # the width direction (DSEC's "x")
    y0 = torch.floor(ev.x)  # the height direction
    t0 = torch.floor(t_norm)
    grid = torch.zeros(c * h * w, dtype=torch.float32, device=ev.x.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dt_ in (0, 1):
                xl = x0 + dx
                yl = y0 + dy
                tl = t0 + dt_
                inb = ((xl >= 0) & (xl < w) & (yl >= 0) & (yl < h)
                       & (tl >= 0) & (tl < c) & ev.valid)
                wgt = (ev.p * (1 - torch.abs(xl - ev.y))
                       * (1 - torch.abs(yl - ev.x))
                       * (1 - torch.abs(tl - t_norm)))
                idx = torch.where(inb, h * w * tl + w * yl + xl, 0).to(
                    torch.int32).long()
                grid.index_add_(0, idx, torch.where(inb, wgt, 0.0).to(
                    torch.float32))
    grid = grid.reshape(voxel_shape)
    if normalize:
        nz = grid != 0
        cnt = nz.sum().clamp(min=1)
        mean = torch.sum(grid * nz) / cnt
        std = torch.sqrt(torch.sum((grid - mean) ** 2 * nz) / cnt)
        grid = torch.where(nz, (grid - mean) / torch.where(std > 0, std, 1.0),
                           grid)
    return grid


def generate_discretized_event_volume(ev: Events,
                                      vol_size: Tuple[int, int, int]
                                      ) -> torch.Tensor:
    """Polarity-separated time-bilinear volume ``[B, H, W]`` (the EventGAN
    representation, ``B`` even): positive events fill bins ``[0, B/2)``,
    the others ``[B/2, B)``; live times scaled to ``[0, B/2 − 1]`` and
    deposited at the floor and ceiling bins with the fractional distances
    as weights."""
    b, h, w = vol_size
    half = b // 2
    x, y = pixel_indices(ev, h, w)
    tmin, tmax = _live_range(ev)
    t_scaled = (ev.t - tmin) * ((half - 1)
                                / torch.clamp(tmax - tmin, min=1e-30))
    t_fl = torch.floor(t_scaled + 1e-8)
    d_ce = t_scaled - t_fl
    d_fl = torch.floor(t_scaled) + 1 - t_scaled
    t_ce = torch.ceil(t_scaled - 1e-8)
    pol_off = torch.where(ev.p < 0, half, 0)
    vol = torch.zeros(b * h * w, dtype=torch.float32, device=ev.x.device)
    for tt, dd in ((t_fl, d_fl), (t_ce, d_ce)):
        tb = tt.to(torch.int32).long() + pol_off
        inb = ev.valid & (tt >= 0) & (tt < half)
        idx = torch.where(inb, (h * w) * tb + w * x + y, 0)
        vol.index_add_(0, idx, torch.where(inb, dd, 0.0).to(torch.float32))
    return vol.reshape(vol_size)
