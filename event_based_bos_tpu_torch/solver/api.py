"""User-facing solver base class.

PyTorch counterpart of the JAX package's ``solver/api.py``: the constructor
signature the reference's solvers take from the YAML config, and the public
methods (``preprocess`` / ``estimate`` / ``estimate_async`` /
``calculate_flow_error(s)`` / ``calculate_fwl`` / ``save_flow_error_as_text``
/ ``visualize_*``) over the port's per-frame estimators.  The concrete
facades live in :mod:`.facades` (re-exported here).

The solver runs on the GPU unless it is built with ``device="cpu"``; with no
GPU it raises.  Event batches are uploaded directly
(``types.events_from_ndarray``, the upload half of the JAX package's
``solver/wire.py``); the quantized wire and the reduced-precision flow fetch
are not ported yet (ROADMAP Queue 1 #16).  The solver's random draws come
from one ``torch.Generator`` on its device, seeded by ``seed``, drawn in
dispatch order.

Device results reach the host through :func:`fetch_later`: the copies are
queued right behind the work that makes them and waited for only when the
host reads them, so a later frame's work queued in between is not waited
for.  Everything runs on the device's current stream, which every thread
of the loop shares (the pipelined loop uploads in a prefetch thread), so
stream order alone orders an upload before its use.

Flow-output convention: ``reference`` (default) returns what the upstream
code returns; ``physical`` negates the generative-model flow so it equals
the pattern displacement in (row, col).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.events import time_period
from ..ops.filters import EventFilter
from ..types import Events, bucket_capacity, events_from_ndarray
from . import programs

logger = logging.getLogger(__name__)

__all__ = ["EstimationHandle", "SolverBase", "fetch_later"]


def fetch_later(tensors: Sequence[torch.Tensor]
                ) -> Callable[[], List[torch.Tensor]]:
    """Start copying ``tensors`` to the host and return ``fetch()``, which
    waits for the copies and returns the host tensors.

    On the card the copies are non-blocking (into pinned memory) and an
    event recorded behind them marks their end; on the CPU they are the
    tensors themselves.
    """
    host = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    cuda = [t.device for t in tensors if t.is_cuda]
    if not cuda:
        return lambda: host
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(cuda[0]))

    def fetch() -> List[torch.Tensor]:
        done.synchronize()
        return host

    return fetch


def _errors_later(pair) -> Callable[[], Tuple[dict, ...]]:
    """:func:`fetch_later` of error dicts of 0-d tensors; ``fetch()``
    returns them as dicts of Python floats (what the error texts print),
    with the keys sorted as the JAX package's fetched dicts have them."""
    keys = [sorted(d) for d in pair]
    fetch = fetch_later([torch.stack([d[k].to(torch.float64)
                                      for d, ks in zip(pair, keys)
                                      for k in ks])])

    def errors() -> Tuple[dict, ...]:
        values = iter(fetch()[0].tolist())
        return tuple({k: next(values) for k in ks} for ks in keys)

    return errors


class EstimationHandle:
    """Deferred result of :meth:`SolverBase.estimate_async`.

    The device work is already queued; :meth:`result` performs the host-side
    finalization (the wait for the flow's copy, bookkeeping) exactly once.
    The pipelined evaluation loop uses this to prepare frame *i+1* on the
    host while frame *i* is on the card.
    """

    def __init__(self, finalize_fn):
        self._fn = finalize_fn
        self._result = None
        self._done = False

    def result(self) -> np.ndarray:
        if not self._done:
            self._result = self._fn()
            self._fn = None
            self._done = True
        return self._result


class SolverBase:
    """The reference's ``SolverBase`` API over the port's estimators."""

    def __init__(self, orig_image_shape, crop_image_shape,
                 calibration_parameter=None, solver_config=None,
                 visualize_module=None, device=None):
        self.orig_image_shape = tuple(orig_image_shape)
        self.crop_image_shape = tuple(crop_image_shape)
        self.calib_param = calibration_parameter or {}
        self.slv_config = solver_config or {}
        self.visualizer = visualize_module
        self.device = resolve_device(device)
        self.padding = int(self.slv_config.get("outer_padding", 0))
        self.pad_image_shape = (crop_image_shape[0] + self.padding,
                                crop_image_shape[1] + self.padding)

        if "filter" in self.slv_config:
            fp = self.slv_config["filter"]["parameters"]
            self.preproc_filter = True
            self.filter_set = EventFilter(self.orig_image_shape,
                                          self.slv_config["filter"])
            self.crop_xmin, self.crop_xmax = fp["xmin"], fp["xmax"]
            self.crop_ymin, self.crop_ymax = fp["ymin"], fp["ymax"]
        else:
            self.preproc_filter = False
            self.crop_xmin, self.crop_ymin = 0, 0
            self.crop_xmax, self.crop_ymax = self.orig_image_shape

        self.dtype = (torch.float64
                      if str(self.slv_config.get("precision", "32")) == "64"
                      else torch.float32)
        model_image = self.slv_config.get("generative_ml", {}).get(
            "model_image", "current")
        if model_image == "e2vid":
            raise NotImplementedError(
                "model_image: e2vid needs the E2VID loader, which is not "
                "ported yet (ROADMAP Queue 1 #14)")
        self.flow_convention = self.slv_config.get("flow_convention",
                                                   "reference")
        self.normalize_t_in_batch = True
        self.previous_frame_best_estimation = None
        self.evaluation_text_list: List[str] = []
        self.motion_model = self.slv_config.get("motion_model", "dense-flow")
        self._generator = torch.Generator(self.device).manual_seed(
            int(self.slv_config.get("seed", 0)))
        self.iter_cnt = 0       # frames finalized
        self.dispatch_cnt = 0   # frames dispatched (pipelined mode runs ahead)
        self._check_wire(self.slv_config)
        logger.info("Solver configuration: %s", self.slv_config)

    @staticmethod
    def _check_wire(slv_config: dict) -> None:
        """The upload and fetch options: the direct upload and the float32
        fetch are the port's; the quantized wire (whose default
        opportunistic mode is bit-identical to the direct upload) and the
        reduced-precision fetch are not ported yet."""
        qu = slv_config.get("quantized_upload", False)
        if qu in (True, "exact", "round"):
            raise NotImplementedError(
                f"quantized_upload: {qu!r} is not ported yet (ROADMAP Queue "
                f"1 #16); the port uploads events directly")
        if qu not in (False, None, "direct"):
            raise ValueError(f"quantized_upload: unknown mode {qu!r} "
                             "(expected true, 'exact', 'round' or 'direct')")
        fetch = str(slv_config.get("flow_fetch_dtype", "float32"))
        if fetch in ("float16", "bfloat16"):
            raise NotImplementedError(
                f"flow_fetch_dtype: {fetch} is not ported yet (ROADMAP Queue "
                f"1 #16); the port fetches float32")
        if fetch != "float32":
            raise ValueError(f"flow_fetch_dtype: unknown dtype {fetch!r} "
                             "(expected float32, float16 or bfloat16)")

    def _to_events(self, events) -> Events:
        """Upload an ``(n, 4)`` event array to the solver's device in a
        power-of-two capacity (or pass :class:`Events` through)."""
        if isinstance(events, Events):
            return events
        arr = np.asarray(events)
        return events_from_ndarray(arr, capacity=bucket_capacity(len(arr)),
                                   dtype=self.dtype, device=self.device)

    def _frame(self, kwargs) -> torch.Tensor:
        """The model frame on the solver's device, in its dtype."""
        return torch.as_tensor(self._model_frame(kwargs)).to(
            device=self.device, dtype=self.dtype)

    def prewarm(self, capacity: int) -> None:
        """Prepare the first frame's work ahead of it.  No-op here; a
        facade that launches kernels builds and loads them.  Never draws
        from the solver's generator."""

    # -- main API ----------------------------------------------------------------
    def preprocess(self, events, need_t: Optional[bool] = None):
        """Filter and upload events; returns ``(events, time_period)``.

        An ``(n, 4)`` array is filtered on the host before the upload (the
        period comes from the raw array); :class:`Events` are filtered on
        their device.  ``need_t`` is accepted for the JAX package's
        signature: the direct upload always carries the timestamps.
        """
        if isinstance(events, np.ndarray):
            num_orig = len(events)
            period = (float(events[:, 2].max() - events[:, 2].min())
                      if num_orig else 0.0)
            if self.preproc_filter:
                events = self.filter_set.process_numpy(events)
                logger.info("After preprocessing %d out of %d.",
                            len(events), num_orig)
            return self._to_events(events), period

        ev = self._to_events(events)
        num_orig = int(ev.count())
        period = float(time_period(ev))
        if self.preproc_filter:
            ev = self.filter_set.process(ev)
            logger.info("After preprocessing %d out of %d.", int(ev.count()),
                        num_orig)
        return ev, period

    def estimate(self, events, *args, **kwargs) -> np.ndarray:
        return self.estimate_async(events, *args, **kwargs).result()

    def estimate_async(self, events, *args, **kwargs) -> EstimationHandle:
        """Queue the per-frame solve; defer the host-side finalization."""
        raise NotImplementedError

    # -- evaluation -----------------------------------------------------------------
    def _eventmask(self, ev: Events) -> torch.Tensor:
        """The ``[1, H, W]`` event mask, memoised per event batch."""
        memo = getattr(self, "_eventmask_memo", None)
        if memo is not None and memo[0] is ev.x:
            return memo[1]
        mask = programs.eventmask(ev, self.orig_image_shape)
        self._eventmask_memo = (ev.x, mask)
        return mask

    def _device_array(self, a) -> torch.Tensor:
        """A host array on the solver's device, in its own dtype."""
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def calculate_flow_errors(self, pred_disp, gt_flow, events,
                              roi: dict) -> tuple:
        """The (unmasked, event-masked) error dicts of the ROI-cropped host
        flows, in one fetch."""
        ev = self._to_events(events)
        crop = (roi["xmin"], roi["xmax"], roi["ymin"], roi["ymax"])
        out = _errors_later(programs.flow_error_pair(
            self._device_array(gt_flow)[None],
            self._device_array(pred_disp)[None], ev, self.orig_image_shape,
            crop))()
        logger.info("flow_error = %s", out[0])
        logger.info("flow_error = %s", out[1])
        return out

    def flow_errors_async(self, events, gt_flow, est_device, crop):
        """Queue the (unmasked, event-masked) error pair right behind the
        solve, from the solve's device-resident unoriented flow
        (``EstimationHandle.device_flow``); returns ``fetch() -> tuple``.
        The same numbers as :meth:`calculate_flow_errors` on the cropped
        oriented flow; only the cropped GT is uploaded."""
        ev = self._to_events(events)
        sign = -1.0 if self.flow_convention == "physical" else 1.0
        x0, x1, y0, y1 = crop
        gt_c = self._device_array(np.asarray(gt_flow)[:, x0:x1, y0:y1])
        errors = _errors_later(programs.flow_error_pair_device(
            ev, est_device, gt_c, sign, self.orig_image_shape, tuple(crop)))

        def fetch() -> tuple:
            errs = errors()
            logger.info("flow_error = %s", errs[0])
            logger.info("flow_error = %s", errs[1])
            return errs

        return fetch

    def calculate_flow_error(self, pred_disp, gt_flow,
                             timescale: float = 1.0, events=None,
                             roi: Optional[dict] = None) -> dict:
        """EPE/nPE/AE of two host flows, event-masked when ``events`` is
        given (the mask cropped to ``roi``)."""
        mask = None
        if events is not None:
            mask = self._eventmask(self._to_events(events))
            mask = mask[:, roi["xmin"]:roi["xmax"],
                        roi["ymin"]:roi["ymax"]][None]
        err = programs.flow_error(self._device_array(gt_flow)[None],
                                  self._device_array(pred_disp)[None], mask)
        (out,) = _errors_later([err])()
        logger.info("flow_error = %s for time period %s sec.", out, timescale)
        return out

    def calculate_fwl(self, flow, events) -> dict:
        """FWL = Var(IWE_orig) / Var(IWE) of the events warped by the host
        flow ``flow`` (< 1 is better)."""
        ev = self._to_events(events)
        fwl = programs.fwl(ev, self._device_array(flow).to(self.dtype),
                           self.orig_image_shape,
                           bool(self.normalize_t_in_batch))
        return {"FWL": fwl.item()}

    def calculate_fwl_async(self, events, est_device, scale):
        """:meth:`calculate_fwl` queued behind the solve from its
        device-resident unoriented flow (``EstimationHandle.device_flow``);
        the time rescale and the orientation sign, rounded to float32, fold
        in on the device.  Returns ``fetch() -> dict``."""
        ev = self._to_events(events)
        sign = -1.0 if self.flow_convention == "physical" else 1.0
        factor = float(np.float32(float(scale) * sign))
        flow = (est_device.to(torch.float32) * factor).to(self.dtype)
        fetch = fetch_later([programs.fwl(ev, flow, self.orig_image_shape,
                                          bool(self.normalize_t_in_batch))])
        return lambda: {"FWL": fetch()[0].item()}

    def save_flow_error_as_text(self, nth_frame: int, flow_error_dict: dict,
                                fname: str = "flow_error_per_frame.txt"):
        """Append one frame's results as ``frame N::{dict}`` (the values
        must be Python numbers: the line is parsed back with
        ``ast.literal_eval``)."""
        if getattr(self, "output_dir", None):
            path = os.path.join(self.output_dir, fname)
        else:
            path = fname
        with open(path, "a") as f:
            f.write(f"frame {nth_frame}::" + str(flow_error_dict) + "\n")
        if (path not in self.evaluation_text_list
                and fname != "timestamps_per_frame.txt"):
            self.evaluation_text_list.append(path)

    def set_previous_frame_best_estimation(self, previous_best):
        self.previous_frame_best_estimation = previous_best

    # -- visualization ---------------------------------------------------------------
    def _no_visualizer(self) -> None:
        """The ``visualize_*`` methods do nothing without a visualizer; the
        visualizer is not ported yet."""
        if self.visualizer is not None:
            raise NotImplementedError(
                "visualization is not ported yet (ROADMAP Queue 1 #10b)")

    def visualize_original_sequential(self, *args, **kwargs):
        self._no_visualizer()

    def visualize_pred_sequential(self, *args, **kwargs):
        self._no_visualizer()

    def visualize_gt_sequential(self, *args, **kwargs):
        self._no_visualizer()

    def visualize_flows(self, *args, **kwargs):
        self._no_visualizer()

    def visualize_one_batch_warp(self, *args, **kwargs):
        self._no_visualizer()

    def visualize_one_batch_warp_gt(self, *args, **kwargs):
        self._no_visualizer()

    # -- model image handling ---------------------------------------------------------
    def _model_frame(self, kwargs) -> np.ndarray:
        mode = self.slv_config.get("generative_ml", {}).get("model_image",
                                                            "current")
        if mode == "current":
            return np.asarray(kwargs["frame"])
        if mode == "black":
            return np.zeros_like(np.asarray(kwargs["frame"]))
        if mode == "background":
            if getattr(self, "_background", None) is None:
                self._background = np.asarray(kwargs["background"])
            return self._background
        raise ValueError(f"Unknown model_image {mode!r}")

    def _orient_flow(self, flow: np.ndarray) -> np.ndarray:
        """Apply the output convention (see the module docstring)."""
        if self.flow_convention == "physical":
            return -flow
        return flow


# the concrete facades subclass SolverBase above; re-exported here so that
# ``solver.api.collections`` and the class names work as in the JAX package
from .facades import (  # noqa: E402,F401
    ContrastMaximization,
    GenerativeMaximumLikelihood,
    PatchEklt,
    PatchEkltDependent,
    PatchEkltPyramid2,
    collections,
)

__all__ += ["ContrastMaximization", "PatchEkltPyramid2", "collections"]
