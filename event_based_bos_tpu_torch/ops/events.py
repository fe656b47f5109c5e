"""Event-batch operations: masking, generation and transforms.

PyTorch counterpart of the JAX package's ``ops/events.py``.  Every filter
(crop, remove, time window, polarity split, thinning) is a validity-mask
update on the fixed-capacity batch, so shapes never depend on the data.
Random draws take an explicit ``torch.Generator`` where the JAX package
takes a key: the two streams differ.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import resolve_device
from ..types import Events, events_from_arrays

__all__ = ["generate_events", "crop_event", "remove_event",
           "filter_event_by_time", "search_exact_event", "shift_event",
           "random_sample_event", "set_event_origin_to_zero",
           "normalize_time", "reverse_event", "sort_event_by_timestamp",
           "split_polarity", "undistort_events", "time_period",
           "pixel_indices"]


def generate_events(generator: torch.Generator, n_events: int, height: int,
                    width: int, tmin: float = 0.0, tmax: float = 0.5,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> Events:
    """Uniform random events on integer pixels, sorted by time, polarity in
    {0, 1}; drawn from ``generator`` (which must live on ``device``, the
    GPU unless the caller asks for another)."""
    dev = resolve_device(device)
    kw = {"generator": generator, "device": dev}
    x = torch.randint(0, height, (n_events,), **kw).to(dtype)
    y = torch.randint(0, width, (n_events,), **kw).to(dtype)
    t = torch.sort(torch.rand((n_events,), dtype=dtype, **kw)
                   * (tmax - tmin) + tmin).values
    p = torch.randint(0, 2, (n_events,), **kw).to(dtype)
    return events_from_arrays(x, y, t, p, dtype=dtype, device=dev)


def crop_event(ev: Events, x0, x1, y0, y1) -> Events:
    """Keep events with ``x0 <= x < x1`` and ``y0 <= y < y1``."""
    keep = (ev.x >= x0) & (ev.x < x1) & (ev.y >= y0) & (ev.y < y1)
    return ev.mask_where(keep)


def remove_event(ev: Events, x0, x1, y0, y1) -> Events:
    """Drop events inside the window (the complement of
    :func:`crop_event`)."""
    inside = (ev.x >= x0) & (ev.x < x1) & (ev.y >= y0) & (ev.y < y1)
    return ev.mask_where(~inside)


def filter_event_by_time(ev: Events, start_time: Optional[float] = None,
                         end_time: Optional[float] = None) -> Events:
    """Keep events with ``start_time <= t < end_time`` (either bound
    optional)."""
    keep = ev.valid
    if start_time is not None:
        keep = keep & (ev.t >= start_time)
    if end_time is not None:
        keep = keep & (ev.t < end_time)
    return ev._replace(valid=keep)


def search_exact_event(ev: Events, x, y) -> Events:
    """Keep the events at exactly pixel ``(x, y)``."""
    return ev.mask_where((ev.x == x) & (ev.y == y))


def shift_event(ev: Events, x0, y0) -> Events:
    """Translate the event coordinates by ``(x0, y0)``."""
    return ev._replace(x=ev.x + x0, y=ev.y + y0)


def random_sample_event(generator: torch.Generator, ev: Events,
                        percentage: float) -> Events:
    """Keep each live event with probability ``percentage`` % (an i.i.d.
    Bernoulli mask drawn from ``generator``)."""
    u = torch.rand(ev.valid.shape, generator=generator, dtype=ev.t.dtype,
                   device=ev.valid.device)
    return ev.mask_where(u < (percentage / 100.0))


def set_event_origin_to_zero(ev: Events, x0, y0, t0=0.0) -> Events:
    """Subtract per-field origins."""
    return ev._replace(x=ev.x - x0, y=ev.y - y0, t=ev.t - t0)


def pixel_indices(ev: Events, h: int, w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row and column of each event, truncated to integers and clamped
    into the ``h × w`` frame (int64 index tensors)."""
    xi = ev.x.to(torch.int32).clamp(0, h - 1).long()
    yi = ev.y.to(torch.int32).clamp(0, w - 1).long()
    return xi, yi


def _masked_min_max(v: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min and max of ``v`` over the slots where ``valid`` (last axis);
    ``+inf`` / ``−inf`` when no slot is live."""
    # Python scalars: no host-to-device copy, which would wait for the
    # stream
    vmin = torch.amin(torch.where(valid, v, torch.inf), dim=-1)
    vmax = torch.amax(torch.where(valid, v, -torch.inf), dim=-1)
    return vmin, vmax


def time_period(ev: Events) -> torch.Tensor:
    """``t.max() − t.min()`` over the live events (a device tensor)."""
    tmin, tmax = _masked_min_max(ev.t, ev.valid)
    return tmax - tmin


def normalize_time(ev: Events) -> Tuple[Events, torch.Tensor]:
    """Live timestamps mapped to [0, 1]; returns ``(events, time_scale)``."""
    tmin, tmax = _masked_min_max(ev.t, ev.valid)
    scale = tmax - tmin
    t = (ev.t - tmin[..., None]) / scale[..., None]
    return ev._replace(t=t), scale


def reverse_event(ev: Events) -> Events:
    """Reverse time (``|tmax − t| + tmin``) and negate polarity."""
    tmin, tmax = _masked_min_max(ev.t, ev.valid)
    t = torch.abs(tmax[..., None] - ev.t) + tmin[..., None]
    return ev._replace(t=t, p=-ev.p)


def sort_event_by_timestamp(ev: Events) -> Events:
    """Sort by timestamp (stable: ties keep their slot order); invalid
    slots sink to the end."""
    key = torch.where(ev.valid, ev.t, torch.inf)
    order = torch.sort(key, dim=-1, stable=True).indices
    return Events(*(torch.take_along_dim(a, order, dim=-1) for a in ev))


def split_polarity(ev: Events) -> Tuple[Events, Events]:
    """``(positive, negative)`` batches by mask; positive means
    ``p > 0``."""
    pos = ev.p > 0
    return ev.mask_where(pos), ev.mask_where(~pos)


def undistort_events(ev: Events, map_x: torch.Tensor, map_y: torch.Tensor,
                     h: int, w: int) -> Events:
    """Rectify the coordinates through integer lookup maps: new row
    ``map_y[x, y]``, new column ``map_x[x, y]``; events mapped outside the
    ``h × w`` frame are dropped (mask).  Integer maps keep the coordinates
    integral."""
    xi, yi = pixel_indices(ev, *map_y.shape)
    k = map_y[xi, yi].to(ev.x.dtype)
    l = map_x[xi, yi].to(ev.y.dtype)
    keep = (k >= 0) & (k < h) & (l >= 0) & (l < w)
    return ev._replace(x=k, y=l).mask_where(keep)
