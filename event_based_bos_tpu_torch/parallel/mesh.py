"""The device mesh: a D×E grid of ranks over ``torch.distributed``.

PyTorch counterpart of the JAX package's ``parallel/mesh.py``.  A JAX mesh
is one program over many devices; here every mesh position is a process
(a rank) with one device, and the axes are process groups: the ``data``
group of a rank holds the ranks with its event index (one per data lane),
its ``event`` group the ranks of its data lane.  Rank ``r`` sits at
``(r // E, r % E)``.

The collectives are built from ``all_reduce`` and ``broadcast`` alone, so
that NCCL (every rank on its own GPU) and gloo (ranks sharing a GPU, or
on the CPU) run the same code; gloo moves a GPU tensor through the host.
A 1×1 mesh needs no process group and makes no collective call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "make_mesh", "default_axis_shape", "world_size",
           "all_reduce_", "broadcast_"]


def world_size() -> int:
    """The size of the initialised default process group (1 without
    one)."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def default_axis_shape(n: int) -> Tuple[int, int]:
    """The JAX package's default split of ``n`` devices into ``(data,
    event)``: ``data`` is the largest power of two that divides ``n`` and
    whose square is at most ``n``, ``event`` the rest."""
    d = 1
    while (d * 2 <= n // (d * 2) * (d * 2) and n % (d * 2) == 0
           and d * d * 4 <= n):
        d *= 2
    if n % d != 0:
        d = 1
    return d, n // d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh of ranks.

    Attributes:
        axis_names: e.g. ``("data", "event")``.
        axis_shape: the size of each axis.
        rank: this rank's global rank (0 without a process group).
        coords: this rank's index along each axis.
        device: this rank's device.
        groups: ``axis -> process group`` of this rank's ranks along the
            axis; None where the axis has size 1.
        backend: the process group's backend (None without one).
    """

    axis_names: Tuple[str, ...]
    axis_shape: Tuple[int, ...]
    rank: int
    coords: Tuple[int, ...]
    device: torch.device
    groups: Dict[str, Optional[object]]
    backend: Optional[str]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_shape:
            n *= s
        return n

    def axis_size(self, axis: Optional[str]) -> int:
        """The size of ``axis`` (1 for an axis the mesh does not have)."""
        return self.shape.get(axis, 1) if axis else 1

    def index(self, axis: Optional[str]) -> int:
        """This rank's index along ``axis`` (0 for a missing axis)."""
        if not axis or axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def global_rank(self, **coords) -> int:
        """The global rank at this rank's coordinates with ``coords``
        replaced (e.g. ``global_rank(event=0)``)."""
        idx = list(self.coords)
        for axis, i in coords.items():
            if axis in self.axis_names:
                idx[self.axis_names.index(axis)] = i
        r = 0
        for i, s in zip(idx, self.axis_shape):
            r = r * s + i
        return r


def _sub_groups(axis_shape, axis_names, rank):
    """One process group per line of the mesh along each axis of size > 1,
    created in the same order on every rank (``new_group`` is
    collective); returns this rank's group of each axis."""
    import itertools

    groups: Dict[str, Optional[object]] = {a: None for a in axis_names}
    for k, axis in enumerate(axis_names):
        if axis_shape[k] == 1:
            continue
        others = [range(s) if j != k else [0]
                  for j, s in enumerate(axis_shape)]
        for base in itertools.product(*others):
            members = []
            for i in range(axis_shape[k]):
                idx = list(base)
                idx[k] = i
                r = 0
                for v, s in zip(idx, axis_shape):
                    r = r * s + v
                members.append(r)
            group = dist.new_group(members)
            if rank in members:
                groups[axis] = group
    return groups


def make_mesh(axis_shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "event"),
              devices=None) -> Mesh:
    """Build this rank's :class:`Mesh` over the initialised process group.

    With no ``axis_shape`` the ranks are split as the JAX package splits
    devices (:func:`default_axis_shape`).  ``devices`` lists one device a
    rank, in rank order (by default each rank's device from the launcher,
    else the current GPU).  A D×E mesh needs a world of exactly D·E ranks;
    a 1×1 mesh also runs without a process group.
    """
    from .launch import rank_device

    world = world_size()
    n = len(devices) if devices is not None else world
    if axis_shape is None:
        axis_shape = default_axis_shape(n)
    axis_shape = tuple(int(s) for s in axis_shape)
    axis_names = tuple(axis_names[:len(axis_shape)])
    size = 1
    for s in axis_shape:
        if s < 1:
            raise ValueError(f"mesh axis sizes must be positive, got "
                             f"{axis_shape}")
        size *= s
    shape_text = "{" + ", ".join(f"{a}: {s}" for a, s in
                                 zip(axis_names, axis_shape)) + "}"
    if size != n or (size > 1 and size != world):
        raise ValueError(f"mesh {shape_text} needs {size} ranks, one device "
                         f"each; the process group has {world}"
                         + (f" and {n} devices were given"
                            if devices is not None else ""))
    rank = dist.get_rank() if world > 1 else 0
    device = (resolve_device(devices[rank]) if devices is not None
              else rank_device())
    coords = []
    r = rank
    for s in reversed(axis_shape):
        coords.append(r % s)
        r //= s
    groups = (_sub_groups(axis_shape, axis_names, rank) if world > 1
              else {a: None for a in axis_names})
    return Mesh(axis_names, axis_shape, rank, tuple(reversed(coords)),
                device, groups, dist.get_backend() if world > 1 else None)


def _through_host(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum ``t`` in place over this rank's ``axis`` group (nothing on an
    axis of size 1)."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    if _through_host(mesh, t):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int) -> torch.Tensor:
    """Overwrite ``t`` on every rank with global rank ``src``'s ``t``
    (nothing on a one-rank mesh)."""
    if mesh.size == 1:
        return t
    if _through_host(mesh, t):
        host = t.cpu()
        dist.broadcast(host, src)
        t.copy_(host)
    else:
        dist.broadcast(t, src)
    return t
