"""Per-event warping under parametric motion models.

PyTorch counterpart of the JAX package's ``ops/warp.py``: each motion model
is a function over the masked :class:`~event_based_bos_tpu_torch.types.Events`
batch, differentiable with respect to the motion (the dense-flow gather is
differentiable with respect to the flow field).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..types import Events
from .events import _masked_min_max

__all__ = [
    "calculate_reftime",
    "calculate_dt",
    "warp_event_2dof",
    "warp_event_dense_flow",
    "warp_event",
    "get_flow_from_motion",
    "motion_model_keys",
    "motion_model_to_motion",
    "motion_model_from_motion",
    "get_motion_vector_size",
]

MOTION_MODELS = ("dense-flow", "2d-translation", "rigid-optical-flow")

_DIRECTION_ALIAS = {"first": 0.0, "middle": 0.5, "last": 1.0, "before": -1.0,
                    "after": 2.0}


def motion_model_keys(motion_model: str):
    """Parameter key names per motion model."""
    if motion_model in MOTION_MODELS:
        return ["trans_x", "trans_y"]
    if motion_model == "scaler":
        return ["scaler"]
    raise KeyError(f"motion_model = {motion_model!r} not supported")


def motion_model_to_motion(motion_model: str, params: dict) -> torch.Tensor:
    """Parameter dict → motion vector."""
    if motion_model in MOTION_MODELS:
        return torch.stack([torch.as_tensor(params["trans_x"]),
                            torch.as_tensor(params["trans_y"])])
    if motion_model == "scaler":
        return torch.stack([torch.as_tensor(params["scaler"])])
    raise KeyError(f"motion_model = {motion_model!r} not supported")


def motion_model_from_motion(motion, motion_model: str) -> dict:
    """Motion vector → parameter dict."""
    keys = motion_model_keys(motion_model)
    return {k: motion[i] for i, k in enumerate(keys)}


def get_motion_vector_size(motion_model: str) -> int:
    """Degrees of freedom of the motion model."""
    return len(motion_model_keys(motion_model))


def calculate_reftime(ev: Events, direction: Union[str, float] = "first",
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Reference timestamp for the warp.

    A float ``direction`` interpolates between the min (0.0) and max (1.0)
    of the live timestamps; strings map as first/middle/last/before/after;
    ``"random"`` draws uniform in [0, 1) from ``generator`` (required, on
    the events' device).
    """
    tmin, tmax = _masked_min_max(ev.t, ev.valid)
    if isinstance(direction, str):
        if direction == "random":
            if generator is None:
                raise ValueError("direction='random' requires a "
                                 "torch.Generator")
            frac = torch.rand(tmin.shape, generator=generator,
                              dtype=ev.t.dtype, device=ev.t.device)
            return tmin + (tmax - tmin) * frac
        try:
            direction = _DIRECTION_ALIAS[direction]
        except KeyError:
            raise ValueError(
                "direction should be first/middle/last/random/before/after "
                f"or float, got {direction!r}") from None
    return tmin + (tmax - tmin) * direction


def calculate_dt(ev: Events, reference_time: torch.Tensor,
                 normalize_t: bool = False,
                 time_period: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``t − t_ref``, optionally normalized so that the span of the live
    events' dt (or ``time_period``) is 1."""
    ref = torch.as_tensor(reference_time, dtype=ev.t.dtype,
                          device=ev.t.device)
    dt = ev.t - ref[..., None]
    if normalize_t:
        if time_period is None:
            dmin, dmax = _masked_min_max(dt, ev.valid)
            time_period = dmax - dmin
        period = torch.as_tensor(time_period, dtype=dt.dtype,
                                 device=dt.device)
        dt = dt / period[..., None]
    return dt


def warp_event_2dof(ev: Events, translation: torch.Tensor,
                    reference_time: torch.Tensor, normalize_t: bool = False,
                    time_period: Optional[torch.Tensor] = None) -> Events:
    """Warp under a constant 2-DoF translation: ``x' = x + dt·trans_x``
    (the reference's sign: −1 from pose to flow times −1 from the warp).
    The result carries ``t = dt``."""
    dt = calculate_dt(ev, reference_time, normalize_t, time_period)
    return ev._replace(x=ev.x + dt * translation[..., 0, None],
                       y=ev.y + dt * translation[..., 1, None],
                       t=dt)


def warp_event_dense_flow(ev: Events, flow: torch.Tensor,
                          reference_time: torch.Tensor,
                          normalize_t: bool = False,
                          time_period: Optional[torch.Tensor] = None
                          ) -> Events:
    """Warp by a dense ``[2, H, W]`` (or ``[..., 2, H, W]``) flow sampled at
    the event's integer pixel: ``x' = x − dt·flow[0, ix, iy]``.

    ``ix``/``iy`` truncate the coordinate toward zero and clip it to the
    frame.  Differentiable with respect to ``flow``.
    """
    dt = calculate_dt(ev, reference_time, normalize_t, time_period)
    h, w = flow.shape[-2:]
    ix = ev.x.to(torch.int32).clamp(0, h - 1).long()
    iy = ev.y.to(torch.int32).clamp(0, w - 1).long()
    fx = flow[..., 0, :, :][..., ix, iy]
    fy = flow[..., 1, :, :][..., ix, iy]
    return ev._replace(x=ev.x - dt * fx, y=ev.y - dt * fy, t=dt)


def warp_event(ev: Events, motion: torch.Tensor, motion_model: str,
               direction: Union[str, float] = "first",
               normalize_t: bool = False,
               time_period: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Events:
    """Dispatch over the motion models."""
    ref_time = calculate_reftime(ev, direction, generator)
    if motion_model == "dense-flow":
        return warp_event_dense_flow(ev, motion, ref_time, normalize_t,
                                     time_period)
    if motion_model in ("2d-translation", "rigid-optical-flow"):
        return warp_event_2dof(ev, motion, ref_time, normalize_t, time_period)
    raise KeyError(f"motion_model = {motion_model!r} not supported")


def get_flow_from_motion(motion: torch.Tensor, motion_model: str,
                         image_size: Tuple[int, int],
                         normalize_t: bool = False) -> torch.Tensor:
    """Densify a rigid motion into a ``[2, H, W]`` flow field by warping one
    unit-time event per pixel and reading off its displacement (with a
    prepended ``t = 0`` event that pins the reference time to 0)."""
    h, w = image_size
    dev = motion.device
    f32 = torch.float32
    gx, gy = torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                            torch.arange(w, dtype=f32, device=dev),
                            indexing="ij")
    n = h * w
    zero = torch.zeros((1,), dtype=f32, device=dev)
    ones = torch.ones((n,), dtype=f32, device=dev)
    x = torch.cat([zero, gx.reshape(-1)])
    y = torch.cat([zero, gy.reshape(-1)])
    t = torch.cat([zero, ones])
    ev = Events(x, y, t, t.clone(),
                torch.ones((n + 1,), dtype=torch.bool, device=dev))
    warped = warp_event(ev, motion, motion_model, direction="first",
                        normalize_t=normalize_t)
    u = -(warped.x[1:] - x[1:]).reshape(h, w)
    v = -(warped.y[1:] - y[1:]).reshape(h, w)
    return torch.stack([u, v], dim=0)
