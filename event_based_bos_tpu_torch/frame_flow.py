"""Frame-based ground-truth flow for the evaluation loop (Farnebäck).

PyTorch port's copy of the JAX package's ``frame_flow.py``: the
``opencv_flow`` branch (OpenCV's Farnebäck flow between the two
ROI-cropped frames, zero-padded to the full frame, on the host) and the
``opencv_flow_two_steps`` branch (each frame's one-step flow from the
background frame, zero-padded, integrated to its uint8 Poisson view on the
estimator's device, then Farnebäck between the two views).  ``cv2`` is
imported only where a flow is computed, so the package imports on a
machine without OpenCV.  The PIV branch (ROADMAP Queue 1 #14b) is not
ported yet and raises.

GT channel convention: the reference transposes the cv2 flow to
``[2, H, W]`` with channel 0 the **column** displacement and channel 1 the
**row** displacement (``"reference"``); ``"physical"`` returns (row, col),
the solver's axis order.
"""

from __future__ import annotations

import numpy as np

from .device import resolve_device

__all__ = ["SUPPORTED_METHODS", "bos_optical_flow", "FrameFlowEstimator"]

SUPPORTED_METHODS = ("opencv_flow", "opencv_flow_two_steps", "openpiv")


def bos_optical_flow(frame_a: np.ndarray, frame_b: np.ndarray, config: dict
                     ) -> np.ndarray:
    """cv2 Farnebäck flow from ``frame_a`` to ``frame_b``; ``[H, W, 2]``."""
    import cv2

    return cv2.calcOpticalFlowFarneback(
        frame_a, frame_b, np.zeros(frame_a.shape + (2,), np.float32),
        config["pyr_scale"], config["levels"], config["winsize"],
        config["iterations"], config["poly_n"], config["poly_sigma"],
        config["flags"])


def _pad_flow(crop_flow: np.ndarray, pad_config: dict) -> np.ndarray:
    """Zero-pad a crop-shaped ``[2, h, w]`` flow to the full frame."""
    return np.pad(crop_flow,
                  [(0, 0),
                   (pad_config["pad_x0"], pad_config["pad_x1"]),
                   (pad_config["pad_y0"], pad_config["pad_y1"])])


class FrameFlowEstimator:
    """GT flow by the configured ``method``; the two-step branch's Poisson
    views run on ``device`` (the GPU unless the caller asks for another).
    """

    def __init__(self, visualizer_module=None, convention: str = "reference",
                 device=None):
        self.visualizer = visualizer_module
        self.device = resolve_device(device)
        if convention not in ("reference", "physical"):
            raise ValueError(f"unknown flow convention {convention!r}")
        self.convention = convention

    def _orient(self, flow_2hw: np.ndarray) -> np.ndarray:
        if self.convention == "physical":
            return flow_2hw[::-1].copy()  # (col, row) → (row, col)
        return flow_2hw

    def estimate(self, method: str, frame0, frame1, frame2, config: dict):
        """Full-frame GT flow ``[2, H, W]`` between ``frame1`` and
        ``frame2`` (the ROI-cropped frames)."""
        if method == "opencv_flow":
            return self.opencv_farneback(frame1, frame2,
                                         config["params_opencv_flow"])
        if method == "opencv_flow_two_steps":
            return self.opencv_farneback_two_step(
                frame0, frame1, frame2, config["params_opencv_flow"])
        if method in ("openpiv", "openpiv_two_steps"):
            raise NotImplementedError(
                f"the {method} GT is not ported yet (ROADMAP Queue 1 #14b)")
        raise NotImplementedError(f"{method} is not supported")

    def opencv_farneback(self, frame1, frame2, params_opencv_flow,
                         visualize_frame: bool = False) -> np.ndarray:
        """One-step Farnebäck flow between the cropped frames, zero-padded
        to the full frame and oriented; ``visualize_frame`` also renders
        the crop's flow as ``frame_flow_concurrent{i}.png``."""
        f = bos_optical_flow(frame1, frame2, params_opencv_flow)
        if visualize_frame and self.visualizer is not None:
            self.visualizer.visualize_optical_flow(
                f[..., 0], f[..., 1], file_prefix="frame_flow_concurrent")
        crop_flow = f.transpose(2, 0, 1)
        return self._orient(_pad_flow(crop_flow, params_opencv_flow))

    def opencv_farneback_two_step(self, frame0, frame1, frame2,
                                  params_opencv_flow) -> np.ndarray:
        """Background-anchored two-step flow through Poisson integrals.

        Each one-step flow (background ``frame0`` to ``frame1``, and to
        ``frame2``) is zero-padded to the full frame *before* its Poisson
        integration: the DST solution depends on the whole integration
        domain, so integrating the crop would change values inside it too.
        Farnebäck between the two uint8 views then runs at full resolution
        and needs no padding.
        """
        from .visualizer import _poisson_view

        def integral(a, b):
            f = bos_optical_flow(a, b, params_opencv_flow).transpose(2, 0, 1)
            f = _pad_flow(f, params_opencv_flow)
            return _poisson_view(f[1], f[0], self.device)

        p01 = integral(frame0, frame1)
        p02 = integral(frame0, frame2)
        f12 = bos_optical_flow(p01, p02, params_opencv_flow).transpose(2, 0, 1)
        return self._orient(f12)
