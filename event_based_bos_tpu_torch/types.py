"""Core data types: the masked fixed-capacity event batch and patch grids.

PyTorch counterpart of the JAX package's ``types.py``.  An event batch is a
struct of arrays with an explicit validity mask, so masking replaces
filtering and every kernel sees a fixed capacity; **x is the row (height)
coordinate and y the column (width) coordinate**, as in the reference.
The quantized wire codec of the JAX package is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device

__all__ = ["Events", "events_from_arrays", "bucket_capacity",
           "events_from_ndarray", "pad_events", "FlowPatch", "PatchGrid"]


class Events(NamedTuple):
    """Fixed-capacity batch of camera events (struct of tensors).

    Attributes:
        x: ``[(b,) n]`` float tensor. Row (height-direction) coordinate.
        y: ``[(b,) n]`` float tensor. Column (width-direction) coordinate.
        t: ``[(b,) n]`` float tensor. Timestamp in seconds.
        p: ``[(b,) n]`` float tensor. Polarity; positive events have ``p > 0``.
        valid: ``[(b,) n]`` bool tensor. True where the slot holds an event.
    """

    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        """Number of live events (a device tensor; no host sync)."""
        return self.valid.sum(dim=-1)

    def astype(self, dtype: torch.dtype) -> "Events":
        return Events(self.x.to(dtype), self.y.to(dtype), self.t.to(dtype),
                      self.p.to(dtype), self.valid)

    def mask_where(self, keep: torch.Tensor) -> "Events":
        """Return a copy with ``valid &= keep`` (masking = filtering)."""
        return self._replace(valid=torch.logical_and(self.valid, keep))

    def to_numpy(self) -> np.ndarray:
        """Compact to the reference's ragged ``(n, 4)`` ndarray (host copy)."""
        x, y, t, p, valid = (a.detach().cpu().numpy() for a in self)
        m = valid.astype(bool)
        return np.stack([x[m], y[m], t[m], p[m]], axis=-1)


def events_from_arrays(x, y, t, p, capacity: Optional[int] = None,
                       dtype: torch.dtype = torch.float32,
                       device=None) -> Events:
    """Build an :class:`Events` batch from equal-length per-field arrays.

    Pads (with invalid slots) or truncates to ``capacity``.  Runs on the GPU
    unless ``device`` asks for another one.
    """
    dev = resolve_device(device)
    x, y, t, p = (torch.as_tensor(a).to(device=dev, dtype=dtype)
                  for a in (x, y, t, p))
    valid = torch.ones(x.shape[-1:], dtype=torch.bool, device=dev)
    ev = Events(x, y, t, p, valid)
    if capacity is not None and capacity != ev.capacity:
        ev = pad_events(ev, capacity)
    return ev


def bucket_capacity(n: int, minimum: int = 4096) -> int:
    """Smallest power-of-two capacity ≥ n (≥ minimum)."""
    return max(minimum, 1 << math.ceil(math.log2(max(n, 1))))


def events_from_ndarray(events: np.ndarray, capacity: Optional[int] = None,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> Events:
    """Convert the reference-format ``(n, 4)`` array ``(x, y, t, p)``."""
    events = np.asarray(events)
    if events.size == 0:
        dev = resolve_device(device)
        cap = capacity or 0
        z = torch.zeros((cap,), dtype=dtype, device=dev)
        return Events(z, z, z, z, torch.zeros((cap,), dtype=torch.bool,
                                              device=dev))
    return events_from_arrays(events[..., 0], events[..., 1], events[..., 2],
                              events[..., 3], capacity=capacity, dtype=dtype,
                              device=device)


def pad_events(ev: Events, capacity: int) -> Events:
    """Pad (invalid slots appended) or truncate to a new capacity."""
    n = ev.capacity
    if capacity == n:
        return ev
    if capacity < n:
        return Events(*(a[..., :capacity] for a in ev))
    pad = capacity - n

    def _pad(a):
        return torch.cat([a, a.new_zeros(a.shape[:-1] + (pad,))], dim=-1)

    return Events(*(_pad(a) for a in ev))


@dataclasses.dataclass
class FlowPatch:
    """One patch: its center ``(x, y)``, ``shape`` and flow ``(u, v)``,
    with the derived bounds (center ∓ size / 2).  The solvers work on
    whole :class:`PatchGrid` fields; this is the reference's per-patch
    record for code written against it."""

    x: float = 0.0
    y: float = 0.0
    shape: Tuple[int, int] = (0, 0)
    u: float = 0.0
    v: float = 0.0

    @property
    def position(self) -> np.ndarray:
        return np.array([self.x, self.y])

    @property
    def flow(self) -> np.ndarray:
        return np.array([self.u, self.v])

    @property
    def x_min(self) -> float:
        return self.x - self.shape[0] / 2

    @property
    def x_max(self) -> float:
        return self.x + self.shape[0] / 2

    @property
    def y_min(self) -> float:
        return self.y - self.shape[1] / 2

    @property
    def y_max(self) -> float:
        return self.y + self.shape[1] / 2

    def update(self, u: float, v: float) -> None:
        self.u = float(u)
        self.v = float(v)


@dataclasses.dataclass(frozen=True)
class PatchGrid:
    """Regular grid of square patches tiling an image.

    Attributes:
        image_size: full image (H, W).
        patch_size: patch (h, w).
        stride: sliding window (h, w).
        offset: (h, w) subtracted from every center (pyramid2 ``offset``).
    """

    image_size: Tuple[int, int]
    patch_size: Tuple[int, int]
    stride: Tuple[int, int]
    offset: Tuple[float, float] = (0.0, 0.0)

    @property
    def shape(self) -> Tuple[int, int]:
        """(rows, cols) of the patch grid: ``len(range(0, H - ph + sh, sh))``."""
        h, w = self.image_size
        ph, pw = self.patch_size
        sh, sw = self.stride
        nr = len(range(0, h - ph + sh, sh)) if h - ph + sh > 0 else 0
        nc = len(range(0, w - pw + sw, sw)) if w - pw + sw > 0 else 0
        return nr, nc

    @property
    def n_patch(self) -> int:
        nr, nc = self.shape
        return nr * nc

    def centers(self) -> Tuple[np.ndarray, np.ndarray]:
        """Patch center coordinates ``(cx[rows, cols], cy[rows, cols])``."""
        h, w = self.image_size
        ph, pw = self.patch_size
        sh, sw = self.stride
        cx = (np.arange(0, h - ph + sh, sh, dtype=np.float64) + ph / 2
              - self.offset[0])
        cy = (np.arange(0, w - pw + sw, sw, dtype=np.float64) + pw / 2
              - self.offset[1])
        return np.meshgrid(cx, cy, indexing="ij")

    def bounds(self):
        """Per-patch (x_min, x_max, y_min, y_max) arrays of grid shape."""
        cx, cy = self.centers()
        ph, pw = self.patch_size
        return cx - ph / 2, cx + ph / 2, cy - pw / 2, cy + pw / 2

    def roi_mask(self, xmin, xmax, ymin, ymax) -> np.ndarray:
        """Boolean mask of patches whose center lies inside the ROI
        (boundary-inclusive)."""
        cx, cy = self.centers()
        return (cx >= xmin) & (cx <= xmax) & (cy >= ymin) & (cy <= ymax)
