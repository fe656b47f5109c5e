"""Per-frame evaluation work shared by the solver facades.

PyTorch counterpart of the JAX package's ``solver/programs.py``: the
clipped IWE, the event mask, the FWL metric and the flow-error pairs.  The
JAX package memoised one ``jax.jit`` program per shape; here they are plain
functions on tensors, since nothing is compiled per shape, and the blur the
FWL images take builds its operators once per shape
(``ops/iwe.py::cached_blur_operators``).  Every event image votes through
the CUDA vote kernel on the card (``ops/iwe.py::create_image_from_events``):
the event mask is one launch, the FWL metric two.  The render bundle of the
visualizing loop is not ported yet (ROADMAP Queue 1 #10b).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..costs import normalized_image_variance
from ..ops.flow import calculate_flow_error
from ..ops.iwe import create_eventmask, create_image_from_events
from ..ops.warp import warp_event
from ..types import Events

__all__ = ["clipped_iwe", "eventmask", "fwl", "flow_error",
           "flow_error_pair", "flow_error_pair_device"]

Errors = Dict[str, torch.Tensor]


def clipped_iwe(ev: Events, image_shape, max_scale: float) -> torch.Tensor:
    """IWE render → inverted clipped uint8: clip, truncating uint8 cast,
    then ``255 − x``."""
    im = create_image_from_events(ev, image_shape, sigma=0)
    return 255 - torch.clamp(max_scale * im, 0, 255).to(torch.uint8)


def eventmask(ev: Events, image_shape) -> torch.Tensor:
    """``[1, H, W]`` bool mask of the pixels the events vote into."""
    return create_eventmask(ev, image_shape)


def fwl(ev: Events, flow: torch.Tensor, image_shape,
        normalize_t: bool) -> torch.Tensor:
    """FWL = Var(IWE_orig) / Var(IWE of the events warped by ``flow``)
    (< 1 is better), both IWEs blurred with σ = 1."""
    iwe_orig = create_image_from_events(ev, image_shape, sigma=1)
    warped = warp_event(ev, flow, "dense-flow", direction="middle",
                        normalize_t=normalize_t)
    iwe = create_image_from_events(warped, image_shape, sigma=1)
    return normalized_image_variance({"orig_iwe": iwe_orig, "iwe": iwe})


def flow_error(gt: torch.Tensor, pred: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> Errors:
    """:func:`~event_based_bos_tpu_torch.ops.flow.calculate_flow_error` of
    ``[B, 2, H, W]`` flows, event-masked when ``mask`` is given."""
    return calculate_flow_error(gt, pred, event_mask=mask)


def flow_error_pair(gt: torch.Tensor, pred: torch.Tensor, ev: Events,
                    image_shape, crop: Tuple[int, int, int, int]
                    ) -> Tuple[Errors, Errors]:
    """The (unmasked, event-masked) error dicts of ``[B, 2, h, w]`` flows
    already cropped to ``crop``; the event mask is cropped to match."""
    x0, x1, y0, y1 = crop
    mask = eventmask(ev, image_shape)[:, x0:x1, y0:y1]
    return (calculate_flow_error(gt, pred),
            calculate_flow_error(gt, pred, event_mask=mask[None]))


def flow_error_pair_device(ev: Events, est: torch.Tensor, gt_c: torch.Tensor,
                           err_scale: float, image_shape,
                           crop: Tuple[int, int, int, int]
                           ) -> Tuple[Errors, Errors]:
    """The pair from the solve's full-frame unoriented flow ``est``, on its
    device: ``est`` in float32 times ``err_scale`` (the orientation sign),
    cropped to ``crop``, against the cropped GT ``gt_c`` in float32."""
    x0, x1, y0, y1 = crop
    pred_c = (est.to(torch.float32) * err_scale)[None, :, x0:x1, y0:y1]
    return flow_error_pair(gt_c.to(torch.float32)[None], pred_c, ev,
                           image_shape, crop)
