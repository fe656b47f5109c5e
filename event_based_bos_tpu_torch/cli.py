"""Command-line entry point: the evaluation loop and the run modes.

PyTorch port's copy of the JAX package's ``cli.py``: the same flags
(``--config_file``, ``--log``, ``--eval``), YAML schema and run modes:

  * ``--eval`` → :func:`evaluate_per_frames`: per frame, the GT flow
    (Farnebäck, one- or two-step) and the event window on the host, the
    solve on the card, the render bundle right behind it (clipped IWE,
    event mask, Poisson views, polar planes, error pair), then the error
    texts and the artifacts (PNGs on the Visualizer's writer thread,
    ``pred_flow{i}.npy``, the videos after the loop).  ``visualize:
    false`` is the serving loop: the error pair behind the solve, the
    texts and ``pred_flow{i}.npy`` only.
  * no ``--eval`` → :func:`estimate_sequential` (``run_mode:
    sequential_estimate`` also solves each window), or
    :func:`accumulate_sequential` with ``run_mode: accumulate``.

    python -m event_based_bos_tpu_torch.cli --config_file configs/x.yaml --eval

The loop runs on the GPU; from Python, ``main(argv, device="cpu")`` runs it
on the CPU (without a GPU the command raises).  Not ported yet, and raising
``NotImplementedError``: ``estimation_method: openpiv`` (ROADMAP Queue 1
#14b) and ``mesh:`` (Queue 1 #15).
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time

import numpy as np

from .device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["validate_image", "evaluate_per_frames", "estimate_sequential",
           "accumulate_sequential", "write_videos", "main"]

SUPPORTED_EVALUATION_METHOD = ["opencv_flow", "opencv_flow_two_steps",
                               "openpiv", "openpiv_two_steps"]
SUPPORTED_ESTIMATION_METHOD = ["solver", "openpiv"]


def validate_image(image: np.ndarray, config: dict) -> np.ndarray:
    """ROI crop + even-size check."""
    image = image[..., config["xmin"]:config["xmax"],
                  config["ymin"]:config["ymax"]]
    assert image.shape[0] % 2 == 0, (
        f"Cropped height should be even: {config['xmin']}..{config['xmax']}")
    assert image.shape[1] % 2 == 0, (
        f"Cropped width should be even: {config['ymin']}..{config['ymax']}")
    return image


def _prefetched(items, fn, depth: int = 1):
    """Yield ``fn(item)`` in order, computing up to ``depth`` items ahead in
    a worker thread (host-side IO/GT prefetch for the pipelined loop)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = deque()
        for item in items:
            pending.append(ex.submit(fn, item))
            if len(pending) > depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def evaluate_per_frames(config, loader, solv, viz, device=None,
                        gt_estimator=None):
    """Frame-paced evaluation loop.

    * ``resume: true`` skips the frames the per-frame result manifest
      (:mod:`event_based_bos_tpu_torch.utils.checkpoint`) already holds.
    * ``profile: true`` logs per-section host timings, and those of the
      steady frames (3+) against their wall clock.
    * ``pipeline: true`` prepares frame *i+1* on the host (frame IO, GT,
      event window, filter and upload) in a prefetch thread while frame
      *i* is on the card, and finalizes frame *i* after frame *i+1* is
      queued.  The outputs equal the synchronous loop's bit for bit: the
      same solve, the same generator draws in frame order, frame-ordered
      finalization.
    * ``prewarm`` builds and loads the kernels before the first frame.
    * ``debug_nans`` (set by :func:`main`) raises ``FloatingPointError``
      when a frame's flow or loss history holds a NaN or an infinity.

    Frames are numbered in the producer, in frame order after the
    collapsed-frame check, so resume entries map to the same frames in
    both loop modes.

    ``viz`` is the :class:`~event_based_bos_tpu_torch.visualizer.Visualizer`
    of the artifacts (None: serving).  ``device`` is the solver's device
    (the GPU unless the caller asks for another); ``gt_estimator`` replaces
    the Farnebäck GT (``FrameFlowEstimator(viz, convention, device)``) with
    any object that has its ``estimate(method, frame0, frame1, frame2,
    config)``.
    """
    from . import frame_flow, utils
    from .types import bucket_capacity
    from .utils.checkpoint import FrameResultStore
    from .utils.tracing import Timer

    dev = resolve_device(device)
    if solv.device.type != dev.type:
        raise ValueError(f"the solver runs on {solv.device}, the loop was "
                         f"asked for {dev}")
    if config.get("mesh"):
        raise NotImplementedError(
            "mesh: is not ported yet (ROADMAP Queue 1 #15)")

    store = (FrameResultStore(config["output_dir"])
             if config.get("resume") else None)
    timer = Timer() if config.get("profile") else None
    # the steady-state breakdown: a second timer engaged after the second
    # finalize, reported against the steady wall clock
    steady_timer = Timer() if timer is not None else None
    steady_state = [0, 0.0]  # finalized-frame count; steady window start
    pipeline = bool(config.get("pipeline"))

    eval_config = config["evaluation"]
    metrics = eval_config.get("metrics", [])
    common = config["common_params"]
    crop = (common["xmin"], common["xmax"], common["ymin"], common["ymax"])
    cropped_shape = (config["data"]["crop_height"],
                     config["data"]["crop_width"])
    # the timestamps matter downstream only to the event-warp views and
    # FWL (the port's direct upload carries them either way)
    need_t_downstream = viz is not None or "fwl" in metrics
    eval_dt = eval_config["dt"]
    n_events = config["data"].get("n_events_per_batch")
    max_event_dt = config["data"].get("max_time_per_event_batch")
    convention = config.get("flow_convention", "reference")
    debug_nans = bool(config.get("debug_nans"))
    estimator = (gt_estimator if gt_estimator is not None
                 else frame_flow.FrameFlowEstimator(viz, convention=convention,
                                                    device=dev))

    prewarm = config.get("prewarm")
    if prewarm:
        # an integer value pins the event capacity; ``true`` derives it
        # from n_events_per_batch
        cap_hint = prewarm if not isinstance(prewarm, bool) else n_events
        if not cap_hint:
            logger.warning("prewarm: true needs n_events_per_batch (or an "
                           "integer prewarm capacity) — skipped.")
        else:
            solv.prewarm(bucket_capacity(int(cap_hint)))

    im0, _ = loader.load_image(0)
    _frame0 = validate_image(im0, common)
    remove_nose = utils.check_key_and_bool(config["data"], "remove_nose")
    roi = dict(zip(("xmin", "xmax", "ymin", "ymax"), crop))

    def _wait_for_card():
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def _section(name):
        if timer is None:
            yield
            return
        with timer.section(name):
            if steady_state[0] >= 2:
                with steady_timer.section(name):
                    yield
            else:
                yield

    # producer-side frame counter, in production order
    _next_frame = [0]

    def produce(i1):
        """Host stage: frame IO, collapse check, frame numbering, resume
        lookup, GT flow and event window, then the filter and the upload.
        Returns ``(tag, i_frame, work)``."""
        with _section("prepare"):
            i2 = i1 + eval_dt
            im1, t1 = loader.load_image(i1)
            im2, t2 = loader.load_image(i2)
            frame1 = validate_image(im1, common)
            frame2 = validate_image(im2, common)
            if frame1.shape != cropped_shape or frame2.shape != cropped_shape:
                logger.warning("Frame may be collapsed — i1=%s i2=%s", i1, i2)
                return ("collapsed", None, None)
            fi = _next_frame[0]
            _next_frame[0] = fi + 1
            if store is not None and fi in store:
                return ("resumed", fi, None)
            work = _prepare_work(im1, t1, t2, frame1, frame2)
        # the upload is synchronous and on the stream every thread shares,
        # so the events are on the card, in order, when the solve takes them
        with _section("preprocess"):
            work["filtered"], work["batch_time_scale"] = (
                solv.preprocess(work["batch"], need_t=need_t_downstream))
        return ("work", fi, work)

    def _prepare_work(im1, t1, t2, frame1, frame2):
        gt_flow = estimator.estimate(config["method"], _frame0, frame1,
                                     frame2, config)
        ind1 = loader.time_to_index(t1)
        ind2 = loader.time_to_index(t2)
        # the original window's events, for the event image of the
        # visualizing loop
        batch_for_gt = (loader.load_event(max(ind1, 0), min(ind2, len(loader)))
                        if viz is not None else None)
        # window rebalancing
        if max_event_dt is not None and t2 - t1 > max_event_dt:
            t2 = t1 + max_event_dt
            ind1 = loader.time_to_index(t1)
            ind2 = loader.time_to_index(t2)
        if n_events is not None:
            if ind2 - ind1 < n_events:
                missing = n_events - (ind2 - ind1)
                ind1 -= missing // 2
                ind2 += missing // 2
            elif ind2 - ind1 > n_events:
                ind1 = ind2 - n_events
        batch = loader.load_event(max(ind1, 0), min(ind2, len(loader)))
        if remove_nose:
            from .ops.events import remove_event
            from .types import events_from_ndarray

            # a host step: the float32 record, masked and compacted
            def nose_removed(arr):
                b = events_from_ndarray(arr, device="cpu")
                return remove_event(b, 0, 120, 990, 1050).to_numpy()

            batch = nose_removed(batch)
            if batch_for_gt is not None:
                batch_for_gt = nose_removed(batch_for_gt)
        return dict(batch=batch, batch_for_gt=batch_for_gt, gt_flow=gt_flow,
                    im1=im1, t1=t1, t2=t2)

    def dispatch(work):
        """Device stage: queue the solve, then the render bundle (with the
        error pair) or the error pair alone, and FWL, right behind it from
        the solve's device-resident flow."""
        with _section("estimate"):
            handle = solv.estimate_async(
                work["filtered"], work["gt_flow"], frame=work["im1"],
                background=im0, frame_time=work["t1"])
            dev_flow = getattr(handle, "device_flow", None)
            ts = work["batch_time_scale"]
            scale = (work["t2"] - work["t1"]) / ts if ts else 1.0
            if dev_flow is not None:
                if "fwl" in metrics:
                    handle.fwl_fetch = solv.calculate_fwl_async(
                        work["filtered"], dev_flow, scale)
                if solv.visualizer is not None:
                    handle.bundle_fetch = solv.render_bundle_async(
                        work["filtered"], None, work["gt_flow"],
                        est_device=dev_flow, est_scale=scale, err_crop=crop)
                else:
                    handle.errors_fetch = solv.flow_errors_async(
                        work["filtered"], work["gt_flow"], dev_flow, crop)
        return handle

    def finalize(work, handle, i_frame):
        with _section("finalize"):
            _finalize(work, handle, i_frame)
        if timer is not None:
            steady_state[0] += 1
            if steady_state[0] == 2:
                steady_state[1] = time.perf_counter()

    def _finalize(work, handle, i_frame):
        if viz is not None:
            # artifact names follow the frame number (resume skips frames)
            viz.set_frame_index(i_frame)
        with _section("finalize/solve_wait"):
            estimation = handle.result()
        if debug_nans:
            _check_finite(i_frame, estimation,
                          getattr(handle, "loss_history", None))
        gt_flow, filtered = work["gt_flow"], work["filtered"]
        t1, t2 = work["t1"], work["t2"]
        batch_time_scale = work["batch_time_scale"]
        scale = (t2 - t1) / batch_time_scale if batch_time_scale else 1.0
        est_scaled = estimation * scale

        errors = None
        with _section("finalize/visualize"):
            if solv.visualizer is not None:
                fetch = getattr(handle, "bundle_fetch", None)
                b = (fetch() if fetch is not None else solv.render_bundle(
                    filtered, est_scaled, gt_flow, est_scale=scale,
                    err_crop=crop))
                errors = b["errors"]
                solv.visualize_original_sequential(
                    work["batch_for_gt"], filtered, clipped=b["clipped"])
                solv.visualize_flows(est_scaled, gt_flow,
                                     polar_pred=b["polar_est"],
                                     polar_gt=b["polar_gt"])
                solv.visualize_pred_sequential(
                    filtered, est_scaled, poisson=b["poisson_est"],
                    mask=b["mask"], polar=b["polar_est"])
                solv.visualize_gt_sequential(
                    filtered, gt_flow, poisson=b["poisson_gt"],
                    mask=b["mask"], polar=b["polar_gt"])

        with _section("finalize/errors"):
            err_fetch = getattr(handle, "errors_fetch", None)
            if errors is not None:
                err_nomask, err_mask = errors
            elif err_fetch is not None:
                err_nomask, err_mask = err_fetch()
            else:
                est_c = estimation[:, crop[0]:crop[1], crop[2]:crop[3]]
                gt_c = gt_flow[:, crop[0]:crop[1], crop[2]:crop[3]]
                err_nomask, err_mask = solv.calculate_flow_errors(
                    est_c, gt_c, filtered, roi)
        solv.save_flow_error_as_text(i_frame, err_nomask,
                                     "flow_error_per_frame_without_mask.txt")
        solv.save_flow_error_as_text(i_frame, err_mask,
                                     "flow_error_per_frame_with_mask.txt")
        if "fwl" in metrics:
            fwl_fetch = getattr(handle, "fwl_fetch", None)
            fwl = (fwl_fetch() if fwl_fetch is not None
                   else solv.calculate_fwl(est_scaled, filtered))
            solv.save_flow_error_as_text(i_frame, fwl, "fwl_per_frame.txt")
        solv.save_flow_error_as_text(i_frame, {"t1": t1, "t2": t2},
                                     "timestamps_per_frame.txt")
        if viz is None:
            # serving mode: the flow itself is the product, named as the
            # visualizer names it
            np.save(os.path.join(config["output_dir"],
                                 f"pred_flow{i_frame}.npy"), est_scaled)
        if store is not None:
            if viz is not None:
                # the manifest marks the frame complete: its artifacts must
                # be on disk first
                viz.flush()
            store.record(i_frame, flow=estimation, t1=float(t1),
                         t2=float(t2), **err_nomask)

    for t_start, t_end in eval_config["time_list"]:
        ind_start = loader.time_to_image_index(t_start) + 1
        ind_end = loader.time_to_image_index(t_end) - eval_dt
        logger.info("Evaluating frames %d..%d", ind_start, ind_end)
        indices = range(ind_start, ind_end)
        # one-deep software pipeline: produce(i+1) ‖ solve(i) ‖ finalize(i−1)
        stream = (_prefetched(indices, produce) if pipeline
                  else (produce(i1) for i1 in indices))
        in_flight = None  # (work, handle, i_frame)
        for tag, fi, work in stream:
            if tag == "collapsed":
                continue
            if tag == "resumed":
                logger.info("Frame %d already computed — skipping (resume).",
                            fi)
                continue
            handle = dispatch(work)
            if pipeline:
                if in_flight is not None:
                    finalize(*in_flight)
                in_flight = (work, handle, fi)
            else:
                # keep the solve's time under 'estimate'
                with _section("estimate"):
                    _wait_for_card()
                finalize(work, handle, fi)
        if in_flight is not None:
            finalize(*in_flight)
    if timer is not None:
        logger.info("Per-section host timings:\n%s", timer.report())
        n_steady = steady_state[0] - 2
        if n_steady > 0:
            wall = time.perf_counter() - steady_state[1]
            logger.info(
                "Steady-state sections (frames 3+, n=%d, wall %.3f "
                "s/frame) — shares of the steady wall:\n%s",
                n_steady, wall / n_steady,
                steady_timer.report(n_frames=n_steady, wall_s=wall))


def _check_finite(i_frame, flow, loss_history) -> None:
    """``debug_nans``: raise ``FloatingPointError`` when frame ``i_frame``'s
    host flow or any of its loss histories (device tensors) holds a NaN or
    an infinity."""
    import torch

    if not np.isfinite(flow).all():
        raise FloatingPointError(f"frame {i_frame}: non-finite flow")
    for i, h in enumerate(loss_history or ()):
        if h is not None and not bool(torch.isfinite(h).all()):
            raise FloatingPointError(
                f"frame {i_frame}: non-finite loss history (scale {i})")


@contextlib.contextmanager
def _nan_checks(enabled: bool):
    """``debug_nans`` for the run: autograd's anomaly mode with its NaN
    check, whose error (a backward function returned NaN) is raised as
    ``FloatingPointError``.  It watches the backward pass only; a NaN in a
    forward intermediate is caught where it reaches the frame's flow or
    loss history (:func:`_check_finite`), not at the operation that made
    it, as JAX's ``jax_debug_nans`` would."""
    if not enabled:
        yield
        return
    import torch

    with torch.autograd.detect_anomaly(check_nan=True):
        try:
            yield
        except RuntimeError as e:
            if "nan values" not in str(e):
                raise
            raise FloatingPointError(str(e)) from e


def estimate_sequential(config, loader, solv, run_estimation: bool = False):
    """Sequential pass over fixed-stride time windows (10 ms apart, each
    ``dt · 8`` ms long): the timestamps text and each window's event image
    and clipped IWE.  ``run_estimation`` (``run_mode:
    sequential_estimate``) also solves each window (warm-started with
    ``warm_start: true``) and renders the flow."""
    eval_config = config["evaluation"]
    eval_dt = eval_config["dt"]
    sliding_window = 0.01
    i_frame = 0
    for t_start, t_end in eval_config["time_list"]:
        for t1 in np.arange(t_start, t_end, sliding_window):
            t2 = t1 + eval_dt * 0.008
            ind1 = loader.time_to_index(t1)
            ind2 = loader.time_to_index(t2)
            batch = loader.load_event(max(ind1, 0), min(ind2, len(loader)))
            filtered, _scale = solv.preprocess(batch)
            solv.save_flow_error_as_text(i_frame, {"t1": t1, "t2": t2},
                                         "timestamps_per_frame.txt")
            solv.visualize_original_sequential(batch, filtered)
            if run_estimation:
                frame = None
                if hasattr(loader, "time_to_image_index"):
                    try:
                        frame, _ts = loader.load_image(
                            max(loader.time_to_image_index(t1), 0))
                    except (NotImplementedError, AssertionError, IndexError):
                        frame = None
                estimation = solv.estimate(filtered, None, frame=frame,
                                           background=frame, frame_time=t1)
                solv.visualize_pred_sequential(filtered, estimation)
            i_frame += 1


def accumulate_sequential(config, loader, solv):
    """Accumulated polarity difference images over fixed-stride windows:
    per time range, the running (positive, negative) vote pair of the raw
    and of the filtered events (one vote launch each a window on the
    card), accumulated in float64 on the solver's device, written as the
    center-standardized ``orig{i}.png`` and ``filter{i}.png``."""
    import torch

    from .ops.image_warp import standardize_image_center
    from .ops.iwe import create_image_from_events
    from .types import events_from_ndarray

    eval_config = config["evaluation"]
    eval_dt = eval_config["dt"]
    sliding_window = 0.01
    shape = solv.orig_image_shape
    i_frame = 0

    def view(pair):
        return standardize_image_center(pair[0] - pair[1]).to(
            torch.uint8).cpu().numpy()

    for t_start, t_end in eval_config["time_list"]:
        pos_neg = torch.zeros((2,) + shape, dtype=torch.float64,
                              device=solv.device)
        filt_pos_neg = torch.zeros_like(pos_neg)
        for t1 in np.arange(t_start, t_end, sliding_window):
            t2 = t1 + eval_dt * 0.008
            ind1 = loader.time_to_index(t1)
            ind2 = loader.time_to_index(t2)
            batch = loader.load_event(max(ind1, 0), min(ind2, len(loader)))
            filtered, _ = solv.preprocess(batch)
            ev = events_from_ndarray(batch, device=solv.device)
            pos_neg += create_image_from_events(ev, shape, "polarity")
            filt_pos_neg += create_image_from_events(filtered, shape,
                                                     "polarity")
            solv.visualizer.visualize_image(view(pos_neg), file_prefix="orig")
            solv.visualizer.visualize_image(view(filt_pos_neg),
                                            file_prefix="filter")
            solv.save_flow_error_as_text(i_frame, {"t1": t1, "t2": t2},
                                         "timestamps_per_frame.txt")
            i_frame += 1


def write_videos(viz, solv) -> None:
    """After a run: drain the Visualizer's writer, finish the video of
    each prefix the solver registered, then the side-by-side comparison
    videos (best-effort: a failure is logged)."""
    viz.flush()
    for v in solv.sequential_video_list:
        logger.info("Make video %s…", v)
        viz.visualize_sequential_images_as_video(v)
    for prefixes, name in (
            (["original", "pred_flow", "gt_flow"], "flow_comparison"),
            (["original", "pred_masked", "gt_masked"],
             "flow_comparison_masked"),
            (["original", "original_filter"], "video_filter_effect")):
        try:
            viz.concat_videos(prefixes, name)
        except Exception as e:  # comparison videos are best-effort
            logger.warning("Video concat skipped: %s", e)


def main(argv=None, device=None):
    """Run the CLI with ``argv`` (``sys.argv[1:]`` by default) on
    ``device`` (the GPU unless the caller asks for another)."""
    from . import data, solver, utils, visualizer

    dev = resolve_device(device)
    config, args = utils.parse_args(argv=argv)
    data_config = config["data"]
    save_dir = config["output_dir"]
    utils.save_config(save_dir, args.config_file, args.log.upper())

    if args.eval:
        assert config["method"] in SUPPORTED_EVALUATION_METHOD
        assert config["estimation_method"] in SUPPORTED_ESTIMATION_METHOD
        if config["estimation_method"] == "openpiv":
            raise NotImplementedError(
                "estimation_method: openpiv (PIV on event histograms) is not "
                "ported yet (ROADMAP Queue 1 #14b)")

    loader = data.collections[data_config["dataset"]](config=data_config)
    loader.set_sequence(data_config["sequence"])

    orig_shape = (data_config["height"], data_config["width"])
    crop_shape = (data_config["crop_height"], data_config["crop_width"])
    # visualize: false = serving: flow arrays and error texts only; the
    # other run modes exist to produce the images
    serving = not config.get("visualize", True)
    if serving and not (args.eval
                        and config.get("estimation_method") == "solver"):
        logger.warning("visualize: false only applies to the solver "
                       "evaluation loop — ignoring.")
        serving = False
    # PNG encodes and history plots run on the writer thread, flushed
    # before the videos are assembled
    viz = (None if serving else
           visualizer.Visualizer(orig_shape, save=True, show=False,
                                 save_dir=save_dir, async_writes=True,
                                 device=dev))

    method_name = config["solver"]["method"]
    config["solver"].setdefault("flow_convention",
                                config.get("flow_convention", "reference"))
    solv = solver.collections[method_name](
        orig_shape, crop_shape, calibration_parameter=loader.load_calib(),
        solver_config=config["solver"], visualize_module=viz, device=dev)
    solv.output_dir = save_dir  # the result texts' directory without viz

    logger.info("Start BOS estimation.")
    with _nan_checks(bool(config.get("debug_nans"))):
        if args.eval:
            evaluate_per_frames(config, loader, solv, viz, device=dev)
        elif config.get("run_mode") == "accumulate":
            accumulate_sequential(config, loader, solv)
        elif config.get("run_mode") == "sequential_estimate":
            estimate_sequential(config, loader, solv, run_estimation=True)
        else:
            estimate_sequential(config, loader, solv)

    if viz is not None:
        write_videos(viz, solv)

    if args.eval:
        for fname in solv.evaluation_text_list:
            _data, stat = utils.read_flow_error_text(fname)
            logger.info("Evaluation %s:\n%s", fname, stat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
