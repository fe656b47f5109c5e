"""Flow evaluation metrics.

PyTorch counterpart of the JAX package's ``ops/flow.py::
calculate_flow_error``: the masked end-point error, the n-pixel outlier
ratios and the angular error of the reference.  The rest of that module
(voxel propagation, GT advection) is not ported yet (ROADMAP Queue 1 #14b).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["calculate_flow_error"]


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
