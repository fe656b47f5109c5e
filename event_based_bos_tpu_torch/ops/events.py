"""Event-batch helpers.

PyTorch counterpart of the part of the JAX package's ``ops/events.py`` that
the warps, the CMax solver and the evaluation loop use: the crop and
remove windows and the time period over live events.  Every filter is a
validity-mask update on the fixed-capacity batch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..types import Events

__all__ = ["crop_event", "remove_event", "time_period"]


def crop_event(ev: Events, x0, x1, y0, y1) -> Events:
    """Keep events with ``x0 <= x < x1`` and ``y0 <= y < y1``."""
    keep = (ev.x >= x0) & (ev.x < x1) & (ev.y >= y0) & (ev.y < y1)
    return ev.mask_where(keep)


def remove_event(ev: Events, x0, x1, y0, y1) -> Events:
    """Drop events inside the window (the complement of
    :func:`crop_event`)."""
    inside = (ev.x >= x0) & (ev.x < x1) & (ev.y >= y0) & (ev.y < y1)
    return ev.mask_where(~inside)


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
