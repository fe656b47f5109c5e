"""User-facing solver base class.

PyTorch counterpart of the JAX package's ``solver/api.py``: the constructor
signature the reference's solvers take from the YAML config, and the public
methods (``preprocess`` / ``estimate`` / ``estimate_async`` /
``calculate_flow_error(s)`` / ``calculate_fwl`` / ``save_flow_error_as_text``
/ ``render_bundle(_async)`` / ``visualize_*``) over the port's per-frame
estimators.  The ``visualize_*`` methods write through the solver's
``Visualizer`` and do nothing without one.  The JAX bundle's
transfer-shrinking options (the cropped GT upload, the ROI-box polar
planes, the bit-packed mask) are not ported: they rebuild the same
full-frame planes that the port's bundle returns directly.  The concrete
facades live in :mod:`.facades` (re-exported here).

The solver runs on the GPU unless it is built with ``device="cpu"``; with no
GPU it raises.  Event batches reach the device through :mod:`.wire` (the
``quantized_upload`` and ``flow_fetch_dtype`` keys); with
``flow_fetch_dtype`` the GT the error pair and the render bundle upload is
rounded to that dtype too, as the estimate is.  The solver's random draws
come from one ``torch.Generator`` on its device, seeded by ``seed``, drawn
in dispatch order.

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

from .. import kernels
from ..device import resolve_device
from ..ops.events import time_period
from ..ops.filters import EventFilter
from ..ops.warp import warp_event
from ..types import Events
from . import programs
from .wire import WireUploadMixin

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


class SolverBase(WireUploadMixin):
    """The reference's ``SolverBase`` API over the port's estimators."""

    #: whether the facade casts the fetched flow to ``flow_fetch_dtype``
    #: (the others reject the option)
    SUPPORTS_FLOW_FETCH_DTYPE = False

    #: whether the facade's solve reads event timestamps; a facade whose
    #: events enter only through the polarity histogram sets this False,
    #: so that :meth:`preprocess` honours ``need_t=False`` (the t-less wire)
    EVENTS_NEED_T = True

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
        self._e2vid_loader = self._setup_e2vid_loader()
        self.flow_convention = self.slv_config.get("flow_convention",
                                                   "reference")
        self.normalize_t_in_batch = True
        self.previous_frame_best_estimation = None
        self.sequential_video_list: List[str] = []
        self.evaluation_text_list: List[str] = []
        self.iwe_visualize_max_scale = self.slv_config.get("max_scale", 50)
        self.motion_model = self.slv_config.get("motion_model", "dense-flow")
        self._generator = torch.Generator(self.device).manual_seed(
            int(self.slv_config.get("seed", 0)))
        self.iter_cnt = 0       # frames finalized
        self.dispatch_cnt = 0   # frames dispatched (pipelined mode runs ahead)
        self._init_wire(self.slv_config)
        logger.info("Solver configuration: %s", self.slv_config)

    def _frame(self, kwargs) -> torch.Tensor:
        """The model frame on the solver's device, in its dtype."""
        return torch.as_tensor(self._model_frame(kwargs)).to(
            device=self.device, dtype=self.dtype)

    def prewarm(self, capacity: int) -> None:
        """Prepare the first frame's work ahead of it: on the card, build
        and load the kernels (every facade votes its events through them).
        Never draws from the solver's generator."""
        if self.device.type == "cuda":
            kernels.library()

    # -- main API ----------------------------------------------------------------
    def preprocess(self, events, need_t: Optional[bool] = None):
        """Filter and upload events; returns ``(events, time_period)``.

        An ``(n, 4)`` array is filtered on the host before the upload (the
        period comes from the raw array, whatever the wire carries);
        :class:`Events` are filtered on their device.  ``need_t=False``
        declares that the caller will not read the timestamps (no FWL, no
        event-warp views): on a facade whose solve is t-free
        (``EVENTS_NEED_T = False``) the array then takes the t-less wire.
        """
        carry_t = self.EVENTS_NEED_T or need_t is None or bool(need_t)
        if isinstance(events, np.ndarray):
            num_orig = len(events)
            period = (float(events[:, 2].max() - events[:, 2].min())
                      if num_orig else 0.0)
            if self.preproc_filter:
                events = self.filter_set.process_numpy(events)
                logger.info("After preprocessing %d out of %d.",
                            len(events), num_orig)
            return self._to_events(events, need_t=carry_t), period

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

    def _gt_array(self, gt) -> torch.Tensor:
        """The GT flow on the device; with ``flow_fetch_dtype`` rounded to
        that dtype on the host (half the upload) and widened to float32 on
        the device, so that it carries the estimate's precision."""
        fetch = self._fetch_dtype
        if fetch is None:
            return self._device_array(gt)
        if fetch == torch.float16:
            # numpy rounds float64 to float16 once (torch goes through
            # float32)
            host = torch.from_numpy(np.asarray(gt, np.float16))
        else:
            host = torch.as_tensor(np.asarray(gt)).to(fetch)
        return host.to(self.device).to(torch.float32)

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
        gt_c = self._gt_array(np.asarray(gt_flow)[:, x0:x1, y0:y1])
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
        fetch = fetch_later([programs.fwl_device(
            ev, est_device, float(scale) * sign, self.orig_image_shape,
            bool(self.normalize_t_in_batch), self.dtype)])
        return lambda: {"FWL": fetch()[0].item()}

    def save_flow_error_as_text(self, nth_frame: int, flow_error_dict: dict,
                                fname: str = "flow_error_per_frame.txt"):
        """Append one frame's results as ``frame N::{dict}`` (the values
        must be Python numbers: the line is parsed back with
        ``ast.literal_eval``)."""
        if self.visualizer is not None:
            path = os.path.join(self.visualizer.save_dir, fname)
        elif getattr(self, "output_dir", None):
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

    def undistort_image(self, image: np.ndarray) -> np.ndarray:
        """Undistort a frame with the calibration ``{"K", "D"}`` given to
        the solver (cv2 on the host; ``orig_image_shape`` is passed as
        cv2's image size, as the JAX package does)."""
        import cv2

        new_mtx, _ = cv2.getOptimalNewCameraMatrix(
            self.calib_param["K"], self.calib_param["D"],
            self.orig_image_shape, 1, self.orig_image_shape)
        return cv2.undistort(image, self.calib_param["K"],
                             self.calib_param["D"], None, new_mtx)

    # -- visualization ---------------------------------------------------------------
    def render_bundle(self, events, est_scaled, gt_flow, est_device=None,
                      est_scale=1.0, err_crop=None) -> dict:
        """Every per-frame visualization plane in one pass and one fetch:
        ``{"clipped", "mask", "poisson_est", "poisson_gt", "polar_est",
        "polar_gt"}`` (numpy), and with ``err_crop`` (the evaluation ROI
        ``(x0, x1, y0, y1)``) the (unmasked, event-masked) error pair of
        the ROI-cropped unscaled flows under ``"errors"``.

        ``est_device`` (+ ``est_scale``) supplies the solve's
        device-resident unoriented flow (``EstimationHandle.device_flow``):
        the time rescale and the orientation sign then apply on the device
        and the host ``est_scaled`` is not uploaded.
        """
        return self.render_bundle_async(events, est_scaled, gt_flow,
                                        est_device=est_device,
                                        est_scale=est_scale,
                                        err_crop=err_crop)()

    def render_bundle_async(self, events, est_scaled, gt_flow,
                            est_device=None, est_scale=1.0, err_crop=None):
        """:meth:`render_bundle` queued now, right behind the solve that
        makes ``est_device``, with its copies to the host started; returns
        ``fetch() -> dict``, which waits for them."""
        ev = self._to_events(events)
        if est_device is not None:
            sign = -1.0 if self.flow_convention == "physical" else 1.0
            est_in = est_device
            sc = float(est_scale) * sign
            err_sc = sign
        else:
            est_in = self._device_array(est_scaled)
            sc = 1.0
            err_sc = 1.0 / float(est_scale) if est_scale else 1.0
        out = programs.render_bundle(
            ev, est_in, self._gt_array(gt_flow), self.orig_image_shape,
            float(self.iwe_visualize_max_scale), sc, err_sc, err_crop)
        planes = fetch_later([out["clipped"], out["mask"], out["poisson_est"],
                              out["poisson_gt"], *out["polar_est"],
                              *out["polar_gt"]])
        errors = _errors_later(out["errors"]) if err_crop is not None else None
        mask_device = out["mask"]

        def fetch() -> dict:
            clipped, mask, poi_est, poi_gt, ang_e, mag_e, ang_g, mag_g = (
                t.numpy() for t in planes())
            if self.padding > 0:
                clipped = clipped[self.padding:-self.padding,
                                  self.padding:-self.padding]
            self._eventmask_memo = (ev.x, mask_device)
            bundle = {"clipped": clipped, "mask": mask,
                      "poisson_est": poi_est, "poisson_gt": poi_gt,
                      "polar_est": (ang_e, mag_e),
                      "polar_gt": (ang_g, mag_g)}
            if errors is not None:
                errs = errors()
                logger.info("flow_error = %s", errs[0])
                logger.info("flow_error = %s", errs[1])
                bundle["errors"] = errs
            return bundle

        return fetch

    def create_clipped_image(self, events, max_scale=50) -> np.ndarray:
        """Inverted clipped IWE for viewing (uint8; one vote launch on the
        card)."""
        ev = self._to_events(events)
        clipped = programs.clipped_iwe(ev, self.orig_image_shape,
                                       float(max_scale)).cpu().numpy()
        if self.padding > 0:
            clipped = clipped[self.padding:-self.padding,
                              self.padding:-self.padding]
        return clipped

    def _register_video(self, prefix: str):
        if prefix not in self.sequential_video_list:
            self.sequential_video_list.append(prefix)
            if self.visualizer is not None:
                # a registered prefix streams its frames into the mp4 as
                # they are written (registration precedes the prefix's
                # first frame in every visualize_* method below)
                self.visualizer.enable_video_stream(prefix)

    def visualize_original_sequential(self, orig_events, filter_events,
                                      clipped=None):
        """The raw window's event image and the filtered window's clipped
        IWE (``clipped``: the render bundle's, else voted here)."""
        if self.visualizer is None:
            return
        orig = (orig_events.to_numpy() if isinstance(orig_events, Events)
                else orig_events)
        self._register_video("original")
        self.visualizer.visualize_event(orig, file_prefix="original")
        if clipped is None:
            clipped = self.create_clipped_image(filter_events,
                                                self.iwe_visualize_max_scale)
        self._register_video("original_filter")
        self.visualizer.visualize_image(clipped, file_prefix="original_filter")

    def visualize_pred_sequential(self, events, flow, poisson=None,
                                  mask=None, polar=None):
        """The estimate's color, ``.npy``, Poisson and event-masked views;
        ``poisson``/``mask``/``polar`` are the render bundle's, else made
        here."""
        if self.visualizer is None:
            return
        flow = np.asarray(flow)
        self._register_video("pred_flow")
        self.visualizer.visualize_optical_flow(
            flow[0], flow[1], visualize_color_wheel=False,
            file_prefix="pred_flow", save_flow=True, polar=polar)
        self._register_video("pred_flow_poisson")
        self.visualizer.visualize_poisson_integration(
            flow, file_prefix="pred_flow_poisson", image=poisson)
        if mask is None:
            mask = self._eventmask(self._to_events(events)).cpu().numpy()
        self._register_video("pred_masked")
        self.visualizer.visualize_optical_flow_on_event_mask(
            flow, None, file_prefix="pred_masked", mask_color="black",
            mask_morph=True, mask=mask, polar=polar)

    def visualize_gt_sequential(self, events, gt_flow, poisson=None,
                                mask=None, polar=None):
        """The GT's color, Poisson and event-masked views."""
        if self.visualizer is None:
            return
        gt_flow = np.asarray(gt_flow)
        self._register_video("gt_flow")
        self.visualizer.visualize_optical_flow(
            gt_flow[0], gt_flow[1], visualize_color_wheel=False,
            file_prefix="gt_flow", save_flow=False, polar=polar)
        self._register_video("gt_flow_poisson")
        self.visualizer.visualize_poisson_integration(
            gt_flow, file_prefix="gt_flow_poisson", image=poisson)
        if mask is None:
            mask = self._eventmask(self._to_events(events)).cpu().numpy()
        self._register_video("gt_masked")
        self.visualizer.visualize_optical_flow_on_event_mask(
            gt_flow, None, file_prefix="gt_masked", mask_color="black",
            mask_morph=True, mask=mask, polar=polar)

    def visualize_flows(self, pred_flow, gt_flow, polar_pred=None,
                        polar_gt=None):
        """The estimate and the GT colorized on one scale."""
        if self.visualizer is None:
            return
        self.visualizer.visualize_optical_flow_pred_and_gt(
            np.asarray(pred_flow), np.asarray(gt_flow),
            pred_file_prefix="flow_comparison_pred",
            gt_file_prefix="flow_comparison_gt",
            polar_pred=polar_pred, polar_gt=polar_gt)

    def visualize_one_batch_warp(self, events, warp=None):
        """The clipped IWE of the events, warped by ``warp`` (the solver's
        motion model) when given."""
        if self.visualizer is None:
            return
        ev = self._to_events(events)
        if warp is not None:
            motion = self._device_array(warp).to(self.dtype)
            ev = warp_event(ev, motion, self.motion_model, direction="middle",
                            normalize_t=self.normalize_t_in_batch)
        clipped = self.create_clipped_image(ev, self.iwe_visualize_max_scale)
        self.visualizer.visualize_image(clipped)

    def visualize_one_batch_warp_gt(self, events, gt_warp,
                                    motion_model: str = "dense-flow"):
        """The clipped IWE of the events warped by the GT (``[2, H, W]`` or
        ``[H, W, 2]``), and with a dense flow its overlay on that image."""
        if self.visualizer is None:
            return
        ev = self._to_events(events)
        gt = np.asarray(gt_warp)
        if motion_model == "dense-flow" and gt.ndim == 3 and gt.shape[-1] == 2:
            gt = gt.transpose(2, 0, 1)
        warped = warp_event(ev, self._device_array(gt).to(self.dtype),
                            motion_model, direction="middle",
                            normalize_t=self.normalize_t_in_batch)
        clipped = self.create_clipped_image(warped,
                                            self.iwe_visualize_max_scale)
        self.visualizer.visualize_image(clipped)
        if motion_model == "dense-flow":
            self.visualizer.visualize_overlay_optical_flow_on_event(gt,
                                                                    clipped)

    # -- model image handling ---------------------------------------------------------
    def _setup_e2vid_loader(self):
        """The E2VID reconstruction loader of ``model_image: e2vid``, from
        ``solver.generative_ml.e2vid`` (the loader's ``root`` /
        ``dataset`` / ``sequence`` keys); None without that section."""
        gml_cfg = self.slv_config.get("generative_ml", {})
        if gml_cfg.get("model_image") != "e2vid" or "e2vid" not in gml_cfg:
            return None
        from ..data.e2vid import E2vidDataLoader

        e2_cfg = dict(gml_cfg["e2vid"])
        sequence = e2_cfg.pop("sequence", None)
        loader = E2vidDataLoader(config=e2_cfg)
        if sequence is not None:
            loader.set_sequence(sequence)
        return loader

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
        if mode == "e2vid":
            return self._e2vid_frame(kwargs)
        raise ValueError(f"Unknown model_image {mode!r}")

    def _e2vid_frame(self, kwargs) -> np.ndarray:
        """The reconstruction of ``model_image: e2vid``: an explicit
        ``e2vid_frame``; else the E2VID loader's image at ``frame_time``
        (at the dispatch count without one: the pipelined loop dispatches
        the next frame before the previous one is finalized); else, with a
        warning, ``frame`` (right only when the data loader is E2VID)."""
        if kwargs.get("e2vid_frame") is not None:
            return np.asarray(kwargs["e2vid_frame"])
        if self._e2vid_loader is not None:
            t = kwargs.get("frame_time")
            index = (max(self._e2vid_loader.time_to_image_index(t), 0)
                     if t is not None else self.dispatch_cnt)
            image, _ts = self._e2vid_loader.load_image(index)
            return np.asarray(image)
        if kwargs.get("frame") is not None:
            logger.warning(
                "model_image 'e2vid' without a generative_ml.e2vid loader "
                "config: using the supplied `frame` as the reconstruction — "
                "valid only with the E2VID data loader.")
            return np.asarray(kwargs["frame"])
        raise ValueError(
            "model_image 'e2vid' needs a generative_ml.e2vid loader config, "
            "an e2vid_frame kwarg, or an E2VID data loader supplying "
            "`frame`.")

    def _viz_diff_scale(self):
        """``generative_ml.viz_diff_scale``: the fixed color scale of the
        DEBUG ``opt_diff`` evolution view."""
        g = self.slv_config.get("generative_ml", {})
        return tuple(g.get("viz_diff_scale", (-0.25, 0.25)))

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

__all__ += ["ContrastMaximization", "GenerativeMaximumLikelihood",
            "PatchEklt", "PatchEkltDependent", "PatchEkltPyramid2",
            "collections"]
