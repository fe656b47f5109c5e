"""DEBUG observability: the optimization-evolution videos.

The port's counterpart of the JAX package's ``solver/evolution.py``.  The
pyramid and the whole-ROI (GML) solves record their parameter trajectory
(``PyramidSpec.record_evolution`` → ``aux["params_history"]``,
``GmlSpec.record_evolution`` → ``aux["theta_history"]``, set by the
``record_evolution`` key or DEBUG logging; first-order methods only);
this module replays it through the generative model on the solve's
device, writes one ``opt_prediction`` / ``opt_measured`` / ``opt_diff``
frame per recorded iterate into a numbered subdirectory per solver call,
and assembles a video of each.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..ops.gradients import frame_gradients
from ..ops.image_warp import range_norm
from .generative import (iwe_cache, measured_increment, params_to_fields,
                         predict_increment, scalar_prediction)

__all__ = ["render_pyramid_evolution", "render_gml_evolution"]

logger = logging.getLogger(__name__)


def _make_child_visualizer(visualizer, iter_cnt: int):
    from ..visualizer import Visualizer

    save_dir = os.path.join(visualizer.save_dir, str(iter_cnt))
    return Visualizer(visualizer._image_size, show=False, save=True,
                      save_dir=save_dir, device=visualizer.device)


def _u8(image: torch.Tensor) -> np.ndarray:
    return image.detach().cpu().numpy().astype(np.uint8)


def _emit(viz, pred: torch.Tensor, measured: torch.Tensor,
          diff_scale=(-0.25, 0.25)):
    diff = pred - measured
    lower, upper = diff_scale
    d_min, d_max = float(diff.min()), float(diff.max())
    # the fixed color scale clips: say so
    if d_min < lower:
        logger.warning("The lowest value in diff is %s but lower scale is %s",
                       d_min, lower)
    if d_max > upper:
        logger.warning("The highest value in diff is %s but upper scale is %s",
                       d_max, upper)
    viz.visualize_image(_u8(range_norm(diff, lower=lower, upper=upper)),
                        file_prefix="opt_diff")
    viz.visualize_image(_u8(range_norm(pred)), file_prefix="opt_prediction")
    viz.visualize_image(_u8(range_norm(measured)), file_prefix="opt_measured")


def render_pyramid_evolution(visualizer, frame, ev, aux, spec,
                             iter_cnt: int = 0,
                             diff_scale=(-0.25, 0.25)) -> None:
    """Render the pyramid solve's recorded trajectory to evolution videos.

    ``aux`` must carry ``params_history`` (``spec.record_evolution > 0``);
    ``frame`` and ``ev`` are the solve's, on its device.  One
    ``opt_prediction`` frame per recorded iterate across all scales, the
    constant ``opt_measured`` view and their ``opt_diff``, under
    ``{save_dir}/{iter_cnt}/``, then one mp4 per prefix.
    """
    if "params_history" not in aux:
        return
    from .pyramid import pyramid_grids

    gen = spec.gen
    viz = _make_child_visualizer(visualizer, iter_cnt)
    fr = torch.as_tensor(frame).to(dtype=gen.dtype)
    gx, gy = frame_gradients(fr, ksize=gen.sobel_ksize,
                             use_log_intensity=gen.use_log_intensity)
    hist, weights, _wi = iwe_cache(ev, gen)
    measured = measured_increment(hist, weights)
    for grid, params_hist in zip(pyramid_grids(spec), aux["params_history"]):
        for p in params_hist:
            fields = params_to_fields(p.to(gen.dtype), grid, gen)
            pred = predict_increment(fields["flow"], gx, gy, gen,
                                     fields.get("pxy"))
            _emit(viz, pred, measured, diff_scale)
    _finish(viz)


def _finish(viz):
    for prefix in ("opt_diff", "opt_prediction", "opt_measured"):
        viz.visualize_sequential_images_as_video(prefix)


def render_gml_evolution(visualizer, frame, ev, aux, spec,
                         iter_cnt: int = 0,
                         diff_scale=(-0.25, 0.25)) -> None:
    """Render the whole-ROI solve's recorded scalar trajectory
    (``aux["theta_history"]``) the same way: each frame is exactly the
    prediction the optimizer saw (:func:`..generative.scalar_prediction`)
    beside the ROI's measurement."""
    if "theta_history" not in aux:
        return
    gen = spec.gen
    viz = _make_child_visualizer(visualizer, iter_cnt)
    fr = torch.as_tensor(frame).to(dtype=gen.dtype)
    gx, gy = frame_gradients(fr, ksize=gen.sobel_ksize,
                             use_log_intensity=gen.use_log_intensity)
    hist, weights, _wi = iwe_cache(ev, gen)
    measured = measured_increment(hist, weights, roi=spec.roi)
    x0, x1, y0, y1 = spec.roi
    weights_roi = None if weights is None else weights[x0:x1, y0:y1]
    for theta in aux["theta_history"]:
        pred, _params = scalar_prediction(theta.to(gen.dtype), gx, gy,
                                          spec.roi, gen, weights_roi)
        _emit(viz, pred, measured, diff_scale)
    _finish(viz)
