"""Core data types: the masked fixed-capacity event batch and patch grids.

PyTorch counterpart of the JAX package's ``types.py``.  An event batch is a
struct of arrays with an explicit validity mask, so masking replaces
filtering and every kernel sees a fixed capacity; **x is the row (height)
coordinate and y the column (width) coordinate**, as in the reference.

The quantized wire (:func:`encode_wire_events` on the host,
:func:`decode_wire_events` on the device) uploads an event batch in 5
B/event without timestamps and 9 B/event with them, against 16 B/event for
the direct float32 upload.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device

__all__ = ["Events", "events_from_arrays", "bucket_capacity",
           "events_from_ndarray", "pad_events", "WIRE_SUBPIXEL",
           "encode_wire_events", "decode_wire_events", "wire_nbytes",
           "FlowPatch", "PatchGrid"]


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


# ---------------------------------------------------------------------------
# Quantized wire format (the serving path's event upload)
# ---------------------------------------------------------------------------
#
# The wire packs an event batch as
#     x, y  → uint16 fixed point (coordinate × 32: exact for 1/32-px-aligned
#             coordinates up to 2047 px, every integer sensor stream among
#             them)
#     p     → int8 raw polarity (±1 and 0/1 streams round-trip exactly)
#     t     → optional: int32 µs after the window's first event, or the raw
#             float32 timestamps when the stream is off the µs grid (the
#             mixed-t tier: the same bytes, decoded bit for bit); omitted
#             when the caller never reads timestamps (the pyramid solve)
#     count → the number of events (the validity mask is rebuilt on the
#             device)
# = 5 B/event without t, 9 B/event with it.  When the encoder accepts a
# batch in "exact" mode the decode reproduces the float32 ``Events`` of the
# direct upload bit for bit in x, y, p and valid (k/32 with k < 2^16 is a
# float32).

WIRE_SUBPIXEL = 32


def encode_wire_events(events: np.ndarray, capacity: int,
                       include_t: bool = True, mode: str = "exact",
                       t_bitwise: bool = False):
    """Host-side wire encoder: a dict of compact numpy arrays, or ``None``
    when the batch cannot be represented (the caller then uploads float32
    directly).

    ``mode="exact"`` rejects batches that would not round-trip bit for bit
    (coordinates off the 1/32-px grid, fractional polarity); timestamps off
    the µs grid (or windows of 2^31 µs and more) take the mixed-t tier
    (``t_f32``) instead.  ``mode="round"`` snaps coordinates onto the grid
    (≤ 1/64 px) and timestamps onto µs (≤ 0.5 µs).  Non-finite values and
    coordinates outside [0, 2047.97] px, or polarity outside int8, refuse
    the batch in both modes.  ``t_bitwise=True`` (the facades' default
    upload) always ships timestamps on the ``t_f32`` tier, whose decode
    equals the direct upload bit for bit on the whole padded array.
    """
    if mode not in ("exact", "round"):
        raise ValueError(f"unknown wire mode {mode!r}")
    events = np.asarray(events)
    n = min(len(events), capacity)
    ev = events[:n]
    if n == 0:
        out = {"x_q": np.zeros(capacity, np.uint16),
               "y_q": np.zeros(capacity, np.uint16),
               "p": np.zeros(capacity, np.int8),
               "count": np.int32(0)}
        if include_t:
            out["t_us"] = np.zeros(capacity, np.int32)
            out["t0"] = np.float32(0)
        return out
    # NaN passes every comparison below as False: gate it explicitly, so
    # that a glitched batch falls back to the float32 upload
    cols = (0, 1, 2, 3) if include_t else (0, 1, 3)
    if not np.isfinite(ev[:, cols]).all():
        return None
    xq = np.rint(ev[:, 0] * WIRE_SUBPIXEL)
    yq = np.rint(ev[:, 1] * WIRE_SUBPIXEL)
    if (xq.min() < 0 or yq.min() < 0
            or xq.max() >= 65536 or yq.max() >= 65536):
        return None
    if mode == "exact":
        # exactness is the round trip itself: the decode's q · 2⁻⁵ is
        # exact, so this host reconstruction equals the device decode
        if not np.array_equal((xq / WIRE_SUBPIXEL).astype(np.float32),
                              ev[:, 0].astype(np.float32)):
            return None
        if not np.array_equal((yq / WIRE_SUBPIXEL).astype(np.float32),
                              ev[:, 1].astype(np.float32)):
            return None
    # polarity ships raw (0/1 or ±1): the voxel ops read its value
    ps = ev[:, 3]
    pq = np.rint(ps)
    if pq.min() < -128 or pq.max() > 127:
        return None
    if mode == "exact" and not np.array_equal(
            pq.astype(np.float32), ps.astype(np.float32)):
        return None
    out = {"x_q": np.zeros(capacity, np.uint16),
           "y_q": np.zeros(capacity, np.uint16),
           "p": np.zeros(capacity, np.int8),
           "count": np.int32(n)}
    out["x_q"][:n] = xq.astype(np.uint16)
    out["y_q"][:n] = yq.astype(np.uint16)
    out["p"][:n] = pq.astype(np.int8)
    if include_t:
        if t_bitwise:
            out["t_f32"] = np.zeros(capacity, np.float32)
            out["t_f32"][:n] = ev[:, 2].astype(np.float32)
            return out
        t0 = float(ev[:, 2].min())
        rel = (ev[:, 2] - t0) * 1e6
        tus = np.rint(rel)
        # 1e-4 µs: above the float64 rounding of (t − t0)·1e6 on a µs
        # stream, far below any timestamp genuinely off the grid
        t_fits_grid = tus.max() < 2**31
        if mode == "exact" and (not t_fits_grid
                                or np.max(np.abs(rel - tus)) > 1e-4):
            out["t_f32"] = np.zeros(capacity, np.float32)
            out["t_f32"][:n] = ev[:, 2].astype(np.float32)
            return out
        if not t_fits_grid:
            return None
        out["t_us"] = np.zeros(capacity, np.int32)
        out["t_us"][:n] = tus.astype(np.int32)
        out["t0"] = np.float32(t0)
    return out


def wire_nbytes(wire: dict) -> int:
    """The bytes :func:`decode_wire_events` uploads for ``wire``."""
    return sum(np.asarray(v).nbytes for v in wire.values())


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array on ``device``, as its own bytes."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def decode_wire_events(wire: dict, dtype: torch.dtype = torch.float32,
                       device=None) -> Events:
    """Upload the wire arrays of :func:`encode_wire_events` to ``device``
    (the GPU unless the caller asks for another) and rebuild the
    :class:`Events` there in ``dtype``.

    The uint16 coordinates travel as an int16 view of the same bytes and
    are widened and masked with ``0xFFFF`` on the device (torch's uint16
    has few operations), so a coordinate still costs 2 B of upload.
    Timestamps decode to ``t0 + µs·1e-6`` in ``dtype`` (within ~2 float32
    ulps of the direct upload), pass through from ``t_f32``, or are zeros
    when the encoder omitted them.  The validity mask is ``arange(cap) <
    count``.
    """
    dev = resolve_device(device)

    def coordinate(q):
        wide = _upload(q.view(np.int16), dev).to(torch.int32) & 0xFFFF
        return wide.to(dtype) * (1.0 / WIRE_SUBPIXEL)

    x = coordinate(wire["x_q"])
    y = coordinate(wire["y_q"])
    cap = x.shape[-1]
    p = _upload(wire["p"], dev).to(dtype)
    if "t_us" in wire:
        t0 = torch.tensor(float(wire["t0"]), dtype=torch.float32).to(dtype)
        t = t0.to(dev) + _upload(wire["t_us"], dev).to(dtype) * torch.tensor(
            1e-6, dtype=dtype, device=dev)
    elif "t_f32" in wire:
        t = _upload(wire["t_f32"], dev).to(dtype)
    else:
        t = torch.zeros((cap,), dtype=dtype, device=dev)
    valid = torch.arange(cap, device=dev) < int(wire["count"])
    return Events(x, y, t, p, valid)


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
