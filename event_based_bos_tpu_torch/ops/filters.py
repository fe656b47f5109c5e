"""Event-stream noise filters and the configured preprocessing pipeline.

PyTorch counterpart of the JAX package's ``ops/filters.py``:

  * :func:`background_activity_filter` — the exact background-activity
    filter (BAF) without a per-event loop: one sort of writer and reader
    records and a segmented prefix-max; bit-identical to the native
    runtime's sequential filter (:mod:`event_based_bos_tpu_torch.runtime`)
    in float64.  The device pipeline's default.
  * :func:`background_activity_filter_fast` — the time-binned
    approximation (``BAF_fast: true``).
  * :func:`hot_pixel_filter` — one event vote (the CUDA vote kernel for a
    CUDA batch) and a threshold.
  * :func:`flicker_filter` — same-pixel polarity flips closer than ``dt``.
  * :class:`EventFilter` — CROP → BAF → HOT from the YAML ``solver.filter``
    section, on the host (:meth:`EventFilter.process_numpy`, through the
    native runtime, before the upload) or on the batch's device
    (:meth:`EventFilter.process`); ``BAF_continuous_update`` carries the
    BAF's time map across windows in either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import runtime
from ..types import Events
from .events import crop_event, pixel_indices
from .iwe import create_iwe

__all__ = ["background_activity_filter", "background_activity_filter_fast",
           "hot_pixel_filter", "flicker_filter", "EventFilter"]

_KNOWN = ("CROP", "BAF", "HOT")


def _segmented_prefix_max(seg: torch.Tensor, val: torch.Tensor
                          ) -> torch.Tensor:
    """Running max of ``val`` restarted wherever ``seg`` (non-decreasing
    int64) changes.  The values become their ranks among the distinct
    values, offset by segment so that every earlier segment's key is below
    every later one's: one ``cummax`` of the keys, mapped back to values."""
    distinct, rank = torch.unique(val, sorted=True, return_inverse=True)
    stride = distinct.numel()
    key = seg * stride + rank
    run = torch.cummax(key, dim=0).values
    return distinct[run - seg * stride]


def background_activity_filter(ev: Events, image_shape: Tuple[int, int],
                               dt: float, ksize: int = 1,
                               num_support_event: int = 1,
                               time_map: Optional[torch.Tensor] = None):
    """The exact background-activity filter (Delbrück 2008), in parallel.

    The semantics of the sequential per-event loop: a per-pixel
    latest-timestamp map (zeros, or ``time_map``), the event's own
    timestamp written before its test, the ``(2k+1)²`` window truncated at
    the frame's edge, and the event kept iff ``t − last < dt`` where
    ``last`` is the ``(num_support + 1)``-th most recent window timestamp
    (``num_support`` clamped to the truncated window).

    The map value an event reads at a window pixel is the max of the
    initial map and of every earlier event's timestamp at that pixel.  So
    one writer record per event (its pixel and time) and one reader record
    per window cell (``(win² + 1)·n`` records) are sorted on ``(pixel,
    event index, writer before reader)`` — one int64 key, ``(pid·n + idx)·2
    + type`` — and a segmented prefix-max over the sorted records gives
    every reader's value.

    Returns ``(filtered_events, updated_time_map)``; the map is ``[H, W]``
    in the events' time dtype.
    """
    h, w = image_shape
    n = ev.x.shape[0]
    k = int(ksize)
    win = 2 * k + 1
    dev = ev.x.device
    tdtype = ev.t.dtype
    sentinel = h * w  # the segment of invalid writers and outside readers

    valid = ev.valid.to(torch.bool)
    xi, yi = pixel_indices(ev, h, w)
    idx = torch.arange(n, device=dev)
    wr_pid = torch.where(valid, xi * w + yi, sentinel)
    wr_val = torch.where(valid, ev.t, -torch.inf)

    offs = torch.arange(-k, k + 1, device=dev)
    dx = offs.repeat_interleave(win)
    dy = offs.repeat(win)
    rx = xi[None, :] + dx[:, None]
    ry = yi[None, :] + dy[:, None]
    inb = (rx >= 0) & (rx < h) & (ry >= 0) & (ry < w) & valid[None, :]
    rd_pid = torch.where(inb, rx * w + ry, sentinel)  # [win², n]

    pid_all = torch.cat([wr_pid, rd_pid.reshape(-1)])
    idx_all = torch.cat([idx, idx.repeat(win * win)])
    # at equal (pixel, index) the writer precedes its own-pixel reader
    typ_all = torch.cat([torch.zeros(n, dtype=torch.int64, device=dev),
                         torch.ones(win * win * n, dtype=torch.int64,
                                    device=dev)])
    order = torch.sort((pid_all * n + idx_all) * 2 + typ_all,
                       stable=True).indices
    val_all = torch.cat([wr_val, torch.full((win * win * n,), -torch.inf,
                                            dtype=tdtype, device=dev)])
    run = _segmented_prefix_max(pid_all[order], val_all[order])
    res_all = torch.empty_like(run)
    res_all[order] = run
    reader_res = res_all[n:].reshape(win * win, n)

    init_flat = (torch.zeros(h * w, dtype=tdtype, device=dev)
                 if time_map is None
                 else time_map.reshape(-1).to(device=dev, dtype=tdtype))
    init_gather = init_flat[rd_pid.clamp(0, h * w - 1)]
    cellv = torch.where(inb, torch.maximum(reader_res, init_gather),
                        -torch.inf)

    svals = torch.sort(cellv, dim=0).values  # missing cells (−inf) first
    m = inb.sum(dim=0).clamp(min=1)
    eff = win * win - 1 - torch.clamp(m - 1, max=num_support_event)
    last = torch.gather(svals, 0, eff[None, :])[0]
    keep = ((ev.t - last) < dt) & valid

    new_map = torch.cat([init_flat, init_flat.new_zeros(1)]).scatter_reduce(
        0, wr_pid, wr_val, reduce="amax")[:h * w].reshape(h, w)
    return ev.mask_where(keep), new_map


def background_activity_filter_fast(ev: Events,
                                    image_shape: Tuple[int, int], dt: float,
                                    ksize: int = 1,
                                    num_support_event: int = 1,
                                    max_bins: int = 64) -> Events:
    """Time-binned BAF approximation: events go into ``dt``-wide bins from
    the first live event on (those beyond ``max_bins`` bins into the last
    one), and an event is kept when at least ``num_support_event`` *other*
    pixels of its ``(2k+1)²`` window fired in its own or the previous bin
    (support age in [0, 2dt) instead of the exact [0, dt)).  One occupancy
    map and summed-area table a bin, all int32: exact."""
    h, w = image_shape
    k = int(ksize)
    tmin = torch.amin(torch.where(ev.valid, ev.t, torch.inf))
    bins = torch.floor((ev.t - tmin) / dt).to(torch.int32).clamp(
        0, max_bins - 1)
    xi, yi = pixel_indices(ev, h, w)
    pid = xi * w + yi
    x0 = (xi - k).clamp(0, h)
    x1 = (xi + k + 1).clamp(0, h)
    y0 = (yi - k).clamp(0, w)
    y1 = (yi + k + 1).clamp(0, w)
    w1 = w + 1

    prev = torch.zeros(h * w, dtype=torch.int32, device=ev.x.device)
    support = torch.zeros_like(pid, dtype=torch.int32)
    for b in range(max_bins):
        sel = ev.valid & (bins == b)
        occ = (torch.zeros_like(prev).scatter_add_(0, pid, sel.to(torch.int32))
               > 0).to(torch.int32)
        both = ((occ + prev) > 0).to(torch.int32)
        sat = torch.nn.functional.pad(
            both.view(h, w).cumsum(0).cumsum(1), (1, 0, 1, 0)).reshape(-1)
        cnt = (sat[x1 * w1 + y1] - sat[x0 * w1 + y1] - sat[x1 * w1 + y0]
               + sat[x0 * w1 + y0])
        support += torch.where(sel, cnt - both[pid], 0).to(torch.int32)
        prev = occ
    return ev.mask_where(support >= num_support_event)


def hot_pixel_filter(ev: Events, image_shape: Tuple[int, int],
                     hot_pixel: float = 10) -> Events:
    """Drop the events on pixels whose vote count exceeds ``hot_pixel``:
    one bilinear vote of the batch (one launch of the vote kernel for a
    CUDA batch), thresholded and read back at each event's pixel."""
    hot = create_iwe(ev, image_shape, sigma=0) > hot_pixel
    xi, yi = pixel_indices(ev, *image_shape)
    return ev.mask_where(~hot[xi, yi])


def flicker_filter(ev: Events, dt: float = 0.01) -> Tuple[Events, Events]:
    """Split events into ``(linked, unlinked)``: two consecutive events at
    one pixel with opposite polarity closer than ``dt`` are linked
    (flicker).

    The events are ordered by ``(x, y, t)`` with stable sorts (ties keep
    slot order), the pixel compared exactly.  The JAX package orders by the
    float key ``x·1e6 + y`` in the events' dtype, which is the same order
    wherever that key is exact (every float64 case); in float32 it is not,
    and pixels of one row that round to one key collide there.
    """
    order = torch.sort(ev.t, stable=True).indices
    for key in (ev.y, torch.where(ev.valid, ev.x, torch.inf)):
        order = order[torch.sort(key[order], stable=True).indices]
    xs, ys, ts, ps, vs = (a[order] for a in ev)
    same = ((xs[1:] == xs[:-1]) & (ys[1:] == ys[:-1]) & vs[1:] & vs[:-1])
    pair = same & (ps[1:] != ps[:-1]) & (ts[:-1] > ts[1:] - dt)
    linked_sorted = torch.zeros_like(vs)
    linked_sorted[:-1] |= pair
    linked_sorted[1:] |= pair
    linked = torch.empty_like(linked_sorted)
    linked[order] = linked_sorted
    return ev.mask_where(linked), ev.mask_where(~linked)


class EventFilter:
    """CROP → BAF → HOT, as configured.

    The filter list comes from the YAML ``solver.filter`` section, and a
    CROP pass is prepended when an ROI is configured
    (``utils/config.py::propagate_config`` always configures one).  The
    device BAF is the exact filter unless ``exact_baf=False`` or the YAML
    parameter ``BAF_fast: true`` picks the time-binned one.
    """

    def __init__(self, image_shape, filter_config,
                 exact_baf: Optional[bool] = None):
        self.image_shape = tuple(image_shape)
        self.params = filter_config.get("parameters", {})
        self.filters = list(filter_config.get("filters") or [])
        if "xmin" in self.params:
            self.filters = ["CROP"] + self.filters
        for name in self.filters:
            if name not in _KNOWN:
                raise KeyError(f"Unknown filter {name!r}")
        self.continuous_update = bool(self.params.get("BAF_continuous_update"))
        if exact_baf is None:
            exact_baf = not bool(self.params.get("BAF_fast", False))
        self.exact_baf = exact_baf
        #: the BAF's latest-time maps carried across windows with
        #: ``BAF_continuous_update``: the device pipeline's and the host's
        self.time_map = None
        self.np_time_map = None

    def process_numpy(self, events: np.ndarray) -> np.ndarray:
        """The pipeline over a raw ``(n, 4)`` host array (before the
        upload); returns the filtered array."""
        for name in self.filters:
            if len(events) < 10:
                return events
            if name == "CROP":
                m = ((events[:, 0] >= self.params["xmin"])
                     & (events[:, 0] < self.params["xmax"])
                     & (events[:, 1] >= self.params["ymin"])
                     & (events[:, 1] < self.params["ymax"]))
                events = events[m]
            elif name == "BAF":
                keep, tmap = runtime.baf_filter(
                    events, self.image_shape, self.params["BAF_dt"],
                    self.params.get("BAF_ksize", 1),
                    self.params.get("BAF_num_support_event", 1),
                    time_map=self.np_time_map)
                self.np_time_map = tmap if self.continuous_update else None
                events = events[keep]
            else:
                keep = runtime.hot_pixel_filter(
                    events, self.image_shape,
                    self.params.get("HOT_thresh", 10))
                events = events[keep]
        return events

    def process(self, ev: Events) -> Events:
        """The pipeline over an uploaded batch on its device (a
        validity-mask update)."""
        for name in self.filters:
            if int(ev.count()) < 10:
                return ev
            if name == "CROP":
                ev = crop_event(ev, self.params["xmin"], self.params["xmax"],
                                self.params["ymin"], self.params["ymax"])
            elif name == "BAF":
                args = (ev, self.image_shape, self.params["BAF_dt"],
                        self.params.get("BAF_ksize", 1),
                        self.params.get("BAF_num_support_event", 1))
                if self.exact_baf:
                    ev, tmap = background_activity_filter(
                        *args, time_map=self.time_map)
                    self.time_map = tmap if self.continuous_update else None
                else:
                    ev = background_activity_filter_fast(*args)
            else:
                ev = hot_pixel_filter(ev, self.image_shape,
                                      self.params.get("HOT_thresh", 10))
        return ev
