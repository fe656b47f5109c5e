"""Optical-flow utilities: generation, time-aware flow voxels, metrics.

PyTorch counterpart of the JAX package's ``ops/flow.py``: the random and
uniform flow generators, the PDE propagation steps (first-order upwind,
inviscid Burgers), the vote propagations (bilinear and max, scatters on
the flow's device), the host-side scipy ``griddata`` propagation, the flow
voxel over time bins (a Python loop over bins where the JAX package scans),
the masked flow errors, and the host-side GT propagation over an arbitrary
window (:func:`estimate_corresponding_gt_flow`, numpy).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

__all__ = ["generate_dense_optical_flow", "generate_uniform_optical_flow",
           "convert_flow_per_bin_to_flow_per_sec", "truncate_voxel_flow",
           "upwind_step", "burgers_step", "propagate_flow_bilinear",
           "propagate_flow_max", "propagate_flow_griddata",
           "construct_dense_flow_voxel", "calculate_flow_error",
           "estimate_corresponding_gt_flow"]


def generate_dense_optical_flow(generator: torch.Generator,
                                image_size: Tuple[int, int],
                                max_val: float = 30.0,
                                device=None) -> torch.Tensor:
    """A random float32 flow ``[2, H, W]`` uniform in ``[−max_val,
    max_val)``, drawn from ``generator`` (on ``device``, the GPU unless the
    caller asks for another)."""
    u = torch.rand((2,) + tuple(image_size), generator=generator,
                   device=resolve_device(device))
    return u * (2 * max_val) - max_val


def generate_uniform_optical_flow(image_size: Tuple[int, int],
                                  x: float = 30.0, y: float = 30.0,
                                  device=None) -> torch.Tensor:
    """A constant float32 flow ``[2, H, W]`` of ``(x, y)``."""
    v = torch.tensor([x, y], dtype=torch.float32,
                     device=resolve_device(device))
    return v[:, None, None].expand((2,) + tuple(image_size))


def convert_flow_per_bin_to_flow_per_sec(flow_per_bin: torch.Tensor,
                                         time_scale: torch.Tensor,
                                         n_bin: int) -> torch.Tensor:
    """The flow per bin divided by the time scale (``n_bin`` is accepted
    for the reference's signature)."""
    return flow_per_bin / time_scale[..., None, None]


def truncate_voxel_flow(flow_voxel: torch.Tensor,
                        scheme: str = "mean") -> torch.Tensor:
    """Collapse a ``[bins, 2, H, W]`` voxel to ``[2, H, W]``: the mean over
    the bins where the flow is nonzero."""
    if scheme != "mean":
        raise NotImplementedError(f"Scheme {scheme} is not implemented")
    mag = torch.linalg.vector_norm(flow_voxel, dim=1, keepdim=True)
    nz = mag > 0.0
    count = nz.sum(dim=0).to(flow_voxel.dtype)
    return (flow_voxel * nz).sum(dim=0) / (count + 1e-6)


def _diff_pads(a: torch.Tensor, axis: int):
    """(backward, forward) one-sided differences along ``axis`` (−2 or −1)
    with a zero boundary."""
    d = torch.diff(a, dim=axis)
    if axis == -1:
        return F.pad(d, (1, 0)), F.pad(d, (0, 1))
    return F.pad(d, (0, 0, 1, 0)), F.pad(d, (0, 0, 0, 1))


def _signed(dt):
    """``(sign(dt), |dt|)`` of a Python number or a tensor."""
    if isinstance(dt, torch.Tensor):
        return torch.sign(dt), torch.abs(dt)
    return (1.0 if dt >= 0 else -1.0), abs(dt)


def upwind_step(flow: torch.Tensor, dt, dx: float = 1.0,
                dy: float = 1.0) -> torch.Tensor:
    """One first-order upwind step of the flow advected by itself; a
    negative ``dt`` propagates backward (the sign-flipped field advected).

    Args:
        flow: ``[(b,) 2, H, W]``.
    """
    squeeze = flow.dim() == 3
    if squeeze:
        flow = flow[None]
    dt_sign, dt_abs = _signed(dt)
    f = flow * dt_sign
    u = f[:, 0:1]
    v = f[:, 1:2]
    u_dx_b, u_dx_f = _diff_pads(u, -2)
    u_dy_b, u_dy_f = _diff_pads(u, -1)
    v_dx_b, v_dx_f = _diff_pads(v, -2)
    v_dy_b, v_dy_f = _diff_pads(v, -1)
    out = f - dt_abs * (
        torch.clamp(u, min=0) * torch.cat([u_dx_b / dx, v_dx_b / dy], 1)
        + torch.clamp(u, max=0) * torch.cat([u_dx_f / dx, v_dx_f / dy], 1)
        + torch.clamp(v, min=0) * torch.cat([u_dy_b / dx, v_dy_b / dy], 1)
        + torch.clamp(v, max=0) * torch.cat([u_dy_f / dx, v_dy_f / dy], 1))
    out = out * dt_sign
    return out[0] if squeeze else out


def burgers_step(flow: torch.Tensor, dt, dx: float = 1.0,
                 dy: float = 1.0) -> torch.Tensor:
    """One inviscid-Burgers step: the conservative flux form for the
    self-advection terms (edge-replicated neighbours), upwind for the
    cross terms."""
    squeeze = flow.dim() == 3
    if squeeze:
        flow = flow[None]
    dt_sign, dt_abs = _signed(dt)
    f = flow * dt_sign
    u = f[:, 0:1]
    v = f[:, 1:2]
    pow_flow = f ** 2 * torch.sign(f)
    u_forw = torch.cat([u[..., 1:, :], u[..., -1:, :]], -2)
    u_back = torch.cat([u[..., :1, :], u[..., :-1, :]], -2)
    v_forw = torch.cat([v[..., 1:], v[..., -1:]], -1)
    v_back = torch.cat([v[..., :1], v[..., :-1]], -1)
    flow_back = torch.cat([u_back, v_back], 1)
    flow_forw = torch.cat([u_forw, v_forw], 1)
    d_back = torch.cat([-u_back * u_back, -v_back * v_back], 1)
    d_forw = torch.cat([u_forw * u_forw, v_forw * v_forw], 1)
    burgers_factor = (
        pow_flow
        + torch.clamp(torch.sign(flow_back), min=0) * d_back
        - torch.clamp(torch.sign(flow_forw), max=0) * d_forw) / 2.0
    u_dy_b, u_dy_f = _diff_pads(u, -1)
    v_dx_b, v_dx_f = _diff_pads(v, -2)
    zeros = torch.zeros_like(u)
    out = f - dt_abs * (
        torch.clamp(u, min=0) * torch.cat([zeros, v_dx_b / dy], 1)
        + torch.clamp(u, max=0) * torch.cat([zeros, v_dx_f / dy], 1)
        + torch.clamp(v, min=0) * torch.cat([u_dy_b / dx, zeros], 1)
        + torch.clamp(v, max=0) * torch.cat([u_dy_f / dx, zeros], 1)
        + burgers_factor)
    out = out * dt_sign
    return out[0] if squeeze else out


def _pushed_corners(flow_0: torch.Tensor, dt):
    """Every pixel pushed by ``dt·flow``: its floor corner (with the 1e-8
    nudge) and fractional parts, flat ``[H·W]``."""
    _, h, w = flow_0.shape
    gx, gy = torch.meshgrid(
        torch.arange(h, dtype=flow_0.dtype, device=flow_0.device),
        torch.arange(w, dtype=flow_0.dtype, device=flow_0.device),
        indexing="ij")
    tx = (flow_0[0] * dt + gx).reshape(-1)
    ty = (flow_0[1] * dt + gy).reshape(-1)
    x1 = torch.floor(tx + 1e-8)
    y1 = torch.floor(ty + 1e-8)
    return h, w, x1, y1, tx - x1, ty - y1


def _corner_index(x1, y1, ddx, ddy, h, w, outside):
    xi = x1 + ddx
    yi = y1 + ddy
    inb = (xi >= 0) & (xi < h) & (yi >= 0) & (yi < w)
    return inb, torch.where(inb, xi * w + yi, outside).to(torch.int64)


def propagate_flow_bilinear(flow_0: torch.Tensor, dt) -> torch.Tensor:
    """Push the flow vectors forward by ``dt`` with a bilinear-vote
    scatter.  As in the reference, the fractional weights pair with
    *transposed* corners: the (row, col + 1) corner takes the row fraction
    and the (row + 1, col) corner the column fraction."""
    h, w, x1, y1, fx, fy = _pushed_corners(flow_0, dt)
    vals = flow_0.reshape(2, -1)
    out = torch.zeros((2, h * w), dtype=flow_0.dtype, device=flow_0.device)
    for ddx, ddy, wgt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                          (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        inb, idx = _corner_index(x1, y1, ddx, ddy, h, w, 0)
        for c in range(2):
            out[c].index_add_(0, idx, torch.where(inb, wgt * vals[c], 0.0))
    return out.reshape(2, h, w)


def propagate_flow_max(flow_0: torch.Tensor, dt) -> torch.Tensor:
    """Push the flow vectors forward keeping, per pixel, the vote of the
    largest ``|u| + |v|``: a scatter-max of the magnitudes, then a
    scatter-max of the winning vectors into zeros, non-finite values
    mapped to 0."""
    h, w, x1, y1, _fx, _fy = _pushed_corners(flow_0, dt)
    vals = flow_0.reshape(2, -1)
    mag = torch.abs(vals[0]) + torch.abs(vals[1])
    best_mag = torch.zeros(h * w + 1, dtype=flow_0.dtype,
                           device=flow_0.device)
    idxs = []
    for ddx, ddy in ((0, 0), (0, 1), (1, 0), (1, 1)):
        inb, idx = _corner_index(x1, y1, ddx, ddy, h, w, h * w)
        idxs.append(idx)
        best_mag = best_mag.scatter_reduce(
            0, idx, torch.where(inb, mag, -torch.inf), reduce="amax")
    out = torch.zeros((2, h * w + 1), dtype=flow_0.dtype,
                      device=flow_0.device)
    for idx in idxs:
        keep = (mag >= best_mag[idx.clamp(max=h * w - 1)]) & (idx < h * w)
        for c in range(2):
            out[c] = out[c].scatter_reduce(
                0, idx, torch.where(keep, vals[c], -torch.inf),
                reduce="amax")
    out = out[:, :h * w]
    return torch.where(torch.isfinite(out), out, 0.0).reshape(2, h, w)


def propagate_flow_griddata(flow_0, dt: float,
                            method: str = "nearest") -> np.ndarray:
    """Host-side propagation by scattered-data re-interpolation: every
    pixel advected to ``x + dt·flow``, the flow re-sampled on the grid with
    ``scipy.interpolate.griddata`` (``nearest``, ``linear`` or ``cubic``;
    the last two leave NaN outside the advected points' hull).  numpy in,
    numpy out."""
    import scipy.interpolate

    flow_0 = np.asarray(flow_0)
    _, h, w = flow_0.shape
    xx, yy = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    src = np.stack([(flow_0[0] * dt + xx).ravel(),
                    (flow_0[1] * dt + yy).ravel()], axis=-1)
    dest = np.stack([xx.ravel(), yy.ravel()], axis=-1)
    flat = flow_0.reshape(2, -1)
    out = np.stack([
        scipy.interpolate.griddata(src, flat[0], dest, method=method),
        scipy.interpolate.griddata(src, flat[1], dest, method=method)])
    return out.reshape(2, h, w)


def construct_dense_flow_voxel(dense_flow: torch.Tensor, time_bin: int,
                               scheme: str = "upwind",
                               t0_location: str = "middle",
                               clamp: Optional[float] = None
                               ) -> torch.Tensor:
    """The flow voxel ``[(b,) bins, 2, H, W]`` over ``time_bin`` bins from
    the flow at ``t0`` (the first or the middle bin).

    Schemes: ``upwind`` / ``burgers`` (PDE steps of ``1/time_bin`` from the
    t0 bin outward), ``bilinear`` / ``max`` (vote propagation by each bin's
    time offset), ``same``, ``zero``, and the host-side ``nearest`` /
    ``linear`` / ``cubic`` (scipy ``griddata``).
    """
    if t0_location not in ("first", "middle"):
        raise NotImplementedError(
            f"t0_location = {t0_location} not supported")
    squeeze = dense_flow.dim() == 3
    if squeeze:
        dense_flow = dense_flow[None]
    t0 = 0 if t0_location == "first" else time_bin // 2

    if scheme in ("upwind", "burgers"):
        step = upwind_step if scheme == "upwind" else burgers_step
        dt = 1.0 / time_bin
        fwd, cur = [], dense_flow
        for _ in range(time_bin - 1 - t0):
            cur = step(cur, dt)
            fwd.append(cur)
        bwd, cur = [], dense_flow
        for _ in range(t0):
            cur = step(cur, -dt)
            bwd.append(cur)
        voxel = torch.stack(bwd[::-1] + [dense_flow] + fwd, dim=1)
    else:
        offset = 0 if t0_location == "first" else time_bin // 2
        ts = [(i - offset) / time_bin for i in range(time_bin)]

        def one(dt):
            if scheme == "bilinear":
                return torch.stack([propagate_flow_bilinear(f, dt)
                                    for f in dense_flow])
            if scheme == "max":
                return torch.stack([propagate_flow_max(f, dt)
                                    for f in dense_flow])
            if scheme == "same":
                return dense_flow
            if scheme == "zero":
                return torch.zeros_like(dense_flow)
            if scheme in ("nearest", "linear", "cubic"):
                host = np.stack([
                    propagate_flow_griddata(f, dt, scheme)
                    for f in dense_flow.detach().cpu().numpy()])
                return torch.as_tensor(host).to(dense_flow)
            raise NotImplementedError(
                f"method = {scheme!r} is not supported.")

        voxel = torch.stack([one(dt) for dt in ts], dim=1)

    if clamp is not None:
        voxel = torch.clamp(voxel, -clamp, clamp)
    return voxel[0] if squeeze else voxel


def calculate_flow_error(flow_gt: torch.Tensor, flow_pred: torch.Tensor,
                         event_mask: Optional[torch.Tensor] = None,
                         time_scale: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """Masked EPE, nPE (n = 1, 2, 3, 5, 10, 20) and AE.

    Valid GT pixels are finite with both components nonzero, intersected
    with ``event_mask`` when given; the point count is the number of valid
    pixels + 1e-5, in the flows' dtype.  AE is the 3-D angular form
    ``arccos((1 + u·u') / (√(1+|u|²)·√(1+|u'|²)))``.

    Args:
        flow_gt, flow_pred: ``[B, 2, H, W]``.
        event_mask: ``[B, 1, H, W]`` bool.
        time_scale: ``[B]`` factors applied to both flows.

    Returns a dict of 0-d tensors (the batch means).
    """
    g0, g1 = flow_gt[:, 0:1], flow_gt[:, 1:2]
    flow_mask = (torch.isfinite(g0) & torch.isfinite(g1)
                 & (g0.abs() > 0) & (g1.abs() > 0))
    total_mask = flow_mask if event_mask is None else (event_mask & flow_mask)
    gt = flow_gt * total_mask
    pred = flow_pred * total_mask
    n_points = total_mask.sum(dim=(1, 2, 3)).to(gt.dtype) + 1e-5
    if time_scale is not None:
        ts = time_scale.reshape(-1, 1, 1, 1)
        gt = gt * ts
        pred = pred * ts

    epe_map = torch.linalg.vector_norm(gt - pred, dim=1)
    errors = {"EPE": torch.mean(epe_map.sum(dim=(1, 2)) / n_points)}
    for n in (1, 2, 3, 5, 10, 20):
        errors[f"{n}PE"] = torch.mean((epe_map > n).sum(dim=(1, 2))
                                      / n_points)
    u, v = pred[:, 0], pred[:, 1]
    ug, vg = gt[:, 0], gt[:, 1]
    cosang = (1.0 + u * ug + v * vg) / (
        torch.sqrt(1 + u * u + v * v) * torch.sqrt(1 + ug * ug + vg * vg))
    errors["AE"] = torch.mean(
        torch.arccos(torch.clamp(cosang, -1.0, 1.0)).sum(dim=(1, 2))
        / n_points)
    return errors


def estimate_corresponding_gt_flow(x_flow_in, y_flow_in, gt_timestamps,
                                   start_time, end_time):
    """Per-interval GT flow maps propagated over an arbitrary window
    ``[start_time, end_time]`` (host numpy): the interval's flow scaled when
    the window lies inside one interval, else a pixel lattice advected by
    nearest-neighbour lookups through each interval in turn, points whose
    sampled flow is exactly 0 zeroed.  Returns ``(x_shift, y_shift)``."""
    gt_iter = int(np.searchsorted(gt_timestamps, start_time,
                                  side="right") - 1)
    gt_dt = gt_timestamps[gt_iter + 1] - gt_timestamps[gt_iter]
    x_flow = np.squeeze(x_flow_in[gt_iter])
    y_flow = np.squeeze(y_flow_in[gt_iter])
    dt = end_time - start_time
    if gt_dt >= dt:
        return x_flow * dt / gt_dt, y_flow * dt / gt_dt

    h, w = x_flow.shape
    x_idx, y_idx = np.meshgrid(np.arange(w, dtype=np.float32),
                               np.arange(h, dtype=np.float32))
    orig_x, orig_y = x_idx.copy(), y_idx.copy()
    x_mask = np.ones_like(x_idx, bool)
    y_mask = np.ones_like(y_idx, bool)

    def prop(xf, yf, scale=1.0):
        xi = np.clip(np.rint(x_idx), 0, w - 1).astype(int)
        yi = np.clip(np.rint(y_idx), 0, h - 1).astype(int)
        fx = xf[yi, xi]
        fy = yf[yi, xi]
        x_mask[fx == 0] = False
        y_mask[fy == 0] = False
        x_idx[...] = x_idx + fx * scale
        y_idx[...] = y_idx + fy * scale

    prop(x_flow, y_flow, (gt_timestamps[gt_iter + 1] - start_time) / gt_dt)
    gt_iter += 1
    while gt_timestamps[gt_iter + 1] < end_time:
        prop(np.squeeze(x_flow_in[gt_iter]), np.squeeze(y_flow_in[gt_iter]))
        gt_iter += 1
    final_dt = end_time - gt_timestamps[gt_iter]
    final_gt_dt = gt_timestamps[gt_iter + 1] - gt_timestamps[gt_iter]
    prop(np.squeeze(x_flow_in[gt_iter]), np.squeeze(y_flow_in[gt_iter]),
         final_dt / final_gt_dt)
    x_shift = x_idx - orig_x
    y_shift = y_idx - orig_y
    x_shift[~x_mask] = 0
    y_shift[~y_mask] = 0
    return x_shift, y_shift
