"""The time-binned CMax stencil on hand-written CUDA kernels.

Counterpart of the JAX package's ``ops/cmax_pallas.py``.
:func:`binned_warp_accumulate` evaluates

    iwe(x) = Σ_b Σ_{o ∈ [−R, R]²} hat(u_b(x)+o_r) · hat(v_b(x)+o_c) · H_b(x+o)

with ``(u_b, v_b) = −dt_b · flow(x)``, zero outside the array given, and is
differentiable with respect to the flow through a backward of the same
shape.  The histograms and ``dts`` are constants (no gradient), as in the
CMax objective, where only the flow is optimized.

The forward and the backward are :func:`cmax_stencil_fwd` and
:func:`cmax_stencil_bwd`: for CUDA tensors each launches its kernel of
``csrc/cmax_stencil.cu`` and raises if it cannot; for CPU tensors they run
:func:`binned_warp_accumulate_plain_fwd` and
:func:`binned_warp_accumulate_plain_bwd`, the full (2R+1)² hat sum, which
is the kernels' specification (the kernels evaluate only the ≤ 2×2 taps per
pixel and bin that can carry weight, and read the histograms in the layout
of :func:`pitched_histograms`).  Both are the hat sum at every radius (not
:func:`~event_based_bos_tpu_torch.ops.image_warp.warp_image_stencil`, which
switches to the extrapolating 4-tap form at R = 1), and both take the TPU
kernel's derivative ``dhat(a) = −sign(a)`` for ``|a| < 1``, else 0: at a
kink it is 0, where autodiff of the hat sum is not.  Inputs are cast to
float32 and the result is float32, as in the TPU kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .image_warp import _shift2

__all__ = ["binned_warp_accumulate", "cmax_stencil_fwd", "cmax_stencil_bwd",
           "binned_warp_accumulate_plain_fwd",
           "binned_warp_accumulate_plain_bwd", "pitched_histograms"]

MAX_RADIUS = 4


def _hat(a: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(a), min=0.0)


def _dhat(a: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's derivative of the hat: −sign(a) inside the support,
    with sign(0) = 0 and 0 at |a| = 1."""
    return torch.where(torch.abs(a) < 1.0, -torch.sign(a), 0.0)


def _check(hists: torch.Tensor, flow: torch.Tensor, dts: torch.Tensor,
           radius: int) -> None:
    if not isinstance(radius, int) or not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius must be an int in 1..{MAX_RADIUS}, "
                         f"got {radius!r}")
    if hists.dim() != 3 or hists.shape[0] < 1:
        raise ValueError(f"hists must be [B, H, W] with B >= 1, got "
                         f"{tuple(hists.shape)}")
    if tuple(flow.shape) != (2,) + tuple(hists.shape[1:]):
        raise ValueError(f"flow must be [2, H, W] = "
                         f"{(2,) + tuple(hists.shape[1:])}, got "
                         f"{tuple(flow.shape)}")
    if tuple(dts.shape) != (hists.shape[0],):
        raise ValueError(f"dts must be [B] = [{hists.shape[0]}], got "
                         f"{tuple(dts.shape)}")
    if not hists.device == flow.device == dts.device:
        raise ValueError("hists, flow and dts must be on one device")
    if hists.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {hists.device}")


def binned_warp_accumulate_plain_fwd(hists: torch.Tensor, flow: torch.Tensor,
                                     dts: torch.Tensor, radius: int = 2
                                     ) -> torch.Tensor:
    """The forward as plain torch ops (float32 in, ``[H, W]`` out)."""
    nd = -dts[:, None, None]
    u = nd * flow[0]
    v = nd * flow[1]
    out = torch.zeros(hists.shape[1:], dtype=hists.dtype, device=hists.device)
    for orow in range(-radius, radius + 1):
        wr = _hat(u + orow)
        for ocol in range(-radius, radius + 1):
            wc = _hat(v + ocol)
            out = out + torch.sum(wr * wc * _shift2(hists, orow, ocol), dim=0)
    return out


def binned_warp_accumulate_plain_bwd(hists: torch.Tensor, flow: torch.Tensor,
                                     dts: torch.Tensor, g: torch.Tensor,
                                     radius: int = 2
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flow's VJP ``(du, dv)`` for the cotangent ``g`` ``[H, W]`` as
    plain torch ops, with the TPU kernel's derivative rule."""
    nd = -dts[:, None, None]
    u = nd * flow[0]
    v = nd * flow[1]
    du = torch.zeros_like(g)
    dv = torch.zeros_like(g)
    for orow in range(-radius, radius + 1):
        au = u + orow
        wr = _hat(au)
        dwr = _dhat(au)
        for ocol in range(-radius, radius + 1):
            av = v + ocol
            wc = _hat(av)
            dwc = _dhat(av)
            gh = g * _shift2(hists, orow, ocol)
            du = du + torch.sum(nd * dwr * wc * gh, dim=0)
            dv = dv + torch.sum(nd * wr * dwc * gh, dim=0)
    return du, dv


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _f32(*ts):
    return tuple(t.detach().to(torch.float32).contiguous() for t in ts)


def _is_pitched(hists: torch.Tensor) -> bool:
    b, h, w = hists.shape
    s0, s1, s2 = hists.stride()
    return (s2 == 1 and s1 % 4 == 0 and s1 >= w and s0 == h * s1
            and hists.data_ptr() % 16 == 0)


def pitched_histograms(hists: torch.Tensor) -> torch.Tensor:
    """``hists`` ``[B, H, W]`` as float32 in the layout the kernels read:
    rows that start on 16 bytes (a row stride that is a multiple of 4
    floats) in planes that follow each other.  Returned as it is when it
    already has that layout (a contiguous array of a width that is a
    multiple of 4, or a view of one); else copied once into a zero-padded
    ``[B, H, W']`` buffer and returned as its view ``[..., :W]``.  The
    kernels never read the columns from ``W`` on."""
    hists = hists.detach().to(torch.float32)
    if _is_pitched(hists):
        return hists
    b, h, w = hists.shape
    buf = torch.zeros((b, h, -(-w // 4) * 4), dtype=torch.float32,
                      device=hists.device)
    buf[..., :w] = hists
    return buf[..., :w]


def cmax_stencil_fwd(hists: torch.Tensor, flow: torch.Tensor,
                     dts: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """The forward ``[H, W]`` float32, without autograd: the kernel for
    CUDA tensors (raises if it cannot launch), the plain version for CPU
    tensors."""
    _check(hists, flow, dts, radius)
    if hists.device.type == "cpu":
        return binned_warp_accumulate_plain_fwd(*_f32(hists, flow, dts),
                                                radius)
    hists = pitched_histograms(hists)
    flow, dts = _f32(flow, dts)
    lib = kernels.library()
    b, h, w = hists.shape
    with torch.cuda.device(flow.device):
        out = torch.empty((h, w), dtype=torch.float32, device=flow.device)
        err = lib.ebt_cmax_stencil_fwd(
            hists.data_ptr(), flow.data_ptr(), dts.data_ptr(), b, h, w,
            hists.stride(1), radius, out.data_ptr(), _stream(flow))
    if err != 0:
        raise RuntimeError(f"cmax_stencil forward kernel launch failed "
                           f"(cudaError {err})")
    kernels.launched("cmax_stencil_fwd")
    return out


def cmax_stencil_bwd(hists: torch.Tensor, flow: torch.Tensor,
                     dts: torch.Tensor, g: torch.Tensor, radius: int = 2
                     ) -> torch.Tensor:
    """The flow's VJP ``[2, H, W]`` float32 for the cotangent ``g``: the
    kernel for CUDA tensors (raises if it cannot launch), the plain version
    for CPU tensors."""
    _check(hists, flow, dts, radius)
    if tuple(g.shape) != tuple(hists.shape[1:]) or g.device != flow.device:
        raise ValueError(f"g must be [H, W] = {tuple(hists.shape[1:])} on "
                         f"the flow's device, got {tuple(g.shape)}")
    if hists.device.type == "cpu":
        return torch.stack(binned_warp_accumulate_plain_bwd(
            *_f32(hists, flow, dts, g), radius))
    hists = pitched_histograms(hists)
    flow, dts, g = _f32(flow, dts, g)
    lib = kernels.library()
    b, h, w = hists.shape
    with torch.cuda.device(flow.device):
        dflow = torch.empty((2, h, w), dtype=torch.float32,
                            device=flow.device)
        err = lib.ebt_cmax_stencil_bwd(
            hists.data_ptr(), flow.data_ptr(), g.data_ptr(), dts.data_ptr(),
            b, h, w, hists.stride(1), radius, dflow[0].data_ptr(),
            dflow[1].data_ptr(), _stream(flow))
    if err != 0:
        raise RuntimeError(f"cmax_stencil backward kernel launch failed "
                           f"(cudaError {err})")
    kernels.launched("cmax_stencil_bwd")
    return dflow


class _BinnedWarpAccumulate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hists, flow, dts, radius):
        ctx.flow_dtype = flow.dtype
        ctx.radius = radius
        ctx.save_for_backward(hists, flow, dts)
        return cmax_stencil_fwd(hists, flow, dts, radius)

    @staticmethod
    def backward(ctx, g):
        # The backward kernel has no derivative of its own, so a second
        # derivative (a Hessian-vector product) must fail, not come out
        # partial.  ``once_differentiable`` is not enough: it hangs its
        # error on detached copies, which a double backward that also
        # reaches the flow through another term never visits.
        if torch.is_grad_enabled():
            raise RuntimeError(
                "binned_warp_accumulate has no second derivative: its "
                "backward cannot run under create_graph=True")
        hists, flow, dts = ctx.saved_tensors
        dflow = cmax_stencil_bwd(hists, flow, dts, g, ctx.radius)
        return None, dflow.to(ctx.flow_dtype), None, None


def binned_warp_accumulate(hists: torch.Tensor, flow: torch.Tensor,
                           dts: torch.Tensor, radius: int = 2
                           ) -> torch.Tensor:
    """``Σ_b stencil_warp(H_b, −dt_b·flow)`` → ``[H, W]`` float32 IWE.

    Args:
        hists: ``[B, H, W]`` per-bin event histograms (no gradient).
        flow: ``[2, H, W]``; the result is differentiable with respect to it
            through :func:`cmax_stencil_bwd`.
        dts: ``[B]`` normalized bin-center offsets (no gradient).
        radius: stencil radius, 1–4 (exact for ``|dt·flow| <= radius``).
    """
    return _BinnedWarpAccumulate.apply(hists, flow, dts, radius)
