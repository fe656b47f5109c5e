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
  * ``--eval`` with ``estimation_method: openpiv`` →
    :func:`evaluate_flow_on_event_grids`: PIV between two event
    histograms a frame instead of the solver.
  * no ``--eval`` → :func:`estimate_sequential` (``run_mode:
    sequential_estimate`` also solves each window), or
    :func:`accumulate_sequential` with ``run_mode: accumulate``.

    python -m event_based_bos_tpu_torch.cli --config_file configs/x.yaml --eval

The loop runs on the GPU; from Python, ``main(argv, device="cpu")`` runs it
on the CPU (without a GPU the command raises).

``mesh: {data: D, event: E}`` runs the evaluation loop on D·E ranks
(:mod:`event_based_bos_tpu_torch.parallel`): the command spawns them
itself, or runs as one of them under ``torchrun --nproc-per-node D·E``.
Every rank reads the frames and uploads the events; each votes its slice
of a frame's events, the lane leaders solve, and only global rank 0
writes (texts, ``.npy`` files, PNGs, videos, the resume manifest and
``main.log``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time

import numpy as np

from .device import resolve_device
from .solver import pyramid

logger = logging.getLogger(__name__)

__all__ = ["validate_image", "mesh_shape", "evaluate_per_frames",
           "evaluate_flow_on_event_grids", "estimate_sequential",
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
    * ``prewarm`` builds and loads the kernels before the first frame and
      (the pyramid) captures the solve program of each schedule.  Without
      it the first frame captures them; a capture runs on a stream of its
      own in ``thread_local`` mode, so the prefetch thread's uploads may go
      on meanwhile.
    * ``debug_nans`` (set by :func:`main`) raises ``FloatingPointError``
      when a frame's flow or loss history holds a NaN or an infinity.
    * ``mesh: {data: D, event: E}`` (in a world of D·E ranks, or 1×1 in
      one process) solves D frames a step, one a data lane, with each
      frame's events voted in E slices
      (``parallel.make_multichip_estimator``); with ``n_restarts: R`` one
      frame a step, its R restarts split over the data lanes
      (``make_multichip_multistart``).  It needs the pyramid solver,
      ``model_image: current`` and no ``warm_start``; each frame's
      coarsest init is drawn from the solver's generator in frame order
      before the step (R a frame with restarts), so a 1×1 mesh gives the
      single-device loop's flows bit for bit.  ``mesh: {…, sequential:
      true}`` with ``warm_start: true`` splits the frames into D
      contiguous segments, one warm-start chain a data lane, advancing in
      lockstep (``make_multichip_sequential``); frame numbers are the
      frames' time-order positions, and with ``resume`` each lane skips
      its computed frames and restarts its chain cold.  Only rank 0
      finalizes and writes.

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
    import torch

    from . import frame_flow, utils
    from .types import bucket_capacity
    from .utils.checkpoint import FrameResultStore
    from .utils.tracing import Timer

    dev = resolve_device(device)
    if solv.device.type != dev.type:
        raise ValueError(f"the solver runs on {solv.device}, the loop was "
                         f"asked for {dev}")

    mesh_cfg = config.get("mesh")
    mesh_sequential = bool(mesh_cfg.get("sequential")) if mesh_cfg else False
    batched_step = seq_steps = mesh_B = None
    writer = True
    if mesh_cfg:
        from .parallel import make_mesh

        mesh_B, mesh_E = mesh_shape(config)
        mesh = make_mesh((mesh_B, mesh_E),
                         devices=None if mesh_B * mesh_E > 1 else [dev])
        if mesh.device != solv.device:
            raise ValueError(f"the solver runs on {solv.device}, this rank "
                             f"on {mesh.device}")
        writer = mesh.rank == 0
        shape = dict(zip(mesh.axis_names, mesh.axis_shape))
        logger.info("Mesh %s: %d ranks, backend %s.", shape, mesh.size,
                    mesh.backend)
        fetch = solv._fetch_dtype
        if mesh_sequential:
            from .parallel import make_multichip_sequential

            seq_steps = make_multichip_sequential(
                solv.spec, mesh, steady_spec=solv.spec_steady,
                fetch_dtype=fetch)
            logger.info(
                "Multi-chip sequential evaluation: mesh %s — %d warm-start "
                "segments in lockstep%s.", shape, mesh_B,
                (" (steady_n_iter=%d)" % solv.spec_steady.n_iter)
                if solv.spec_steady is not None else "")
        elif solv.spec.n_restarts > 1:
            from .parallel import make_multichip_multistart

            batched_step = make_multichip_multistart(solv.spec, mesh,
                                                     fetch_dtype=fetch)
            mesh_B = 1
            logger.info(
                "Multi-chip multi-start: mesh %s — %d restarts sharded over "
                "the data axis, one frame per step.", shape,
                solv.spec.n_restarts)
        else:
            from .parallel import make_multichip_estimator

            batched_step = make_multichip_estimator(solv.spec, mesh,
                                                    fetch_dtype=fetch)
            logger.info("Multi-chip evaluation: mesh %s — %d frames per "
                        "step.", shape, mesh_B)

    # every rank makes the same resume decisions; only rank 0 records
    store = None
    if config.get("resume"):
        store = (FrameResultStore(config["output_dir"]) if writer
                 else _computed_frames(config["output_dir"]))
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
    # FWL; without either, the pyramid (a t-free solve) uploads the t-less
    # wire, 5 B/event
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

    def produce(i1, fi_override=None):
        """Host stage: frame IO, collapse check, frame numbering, resume
        lookup, GT flow and event window, then the filter and the upload.
        Returns ``(tag, i_frame, work)``.  ``fi_override`` (sequential mesh
        mode) numbers the frame by its time-order position."""
        with _section("prepare"):
            i2 = i1 + eval_dt
            im1, t1 = loader.load_image(i1)
            im2, t2 = loader.load_image(i2)
            frame1 = validate_image(im1, common)
            frame2 = validate_image(im2, common)
            if frame1.shape != cropped_shape or frame2.shape != cropped_shape:
                logger.warning("Frame may be collapsed — i1=%s i2=%s", i1, i2)
                return ("collapsed", None, None)
            if fi_override is not None:
                fi = fi_override
            else:
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
        # the GT serves the error texts, which rank 0 alone writes
        gt_flow = (estimator.estimate(config["method"], _frame0, frame1,
                                      frame2, config) if writer else None)
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

    def _inits(n):
        """``n`` coarsest-scale inits from the solver's generator, drawn
        as its solve would draw them (``pyramid.initialize_params`` looked
        up at call time)."""
        shape = pyramid.pyramid_grids(solv.spec)[0].shape
        return [pyramid.initialize_params(solv._generator, shape, solv.gen,
                                          solv.device) for _ in range(n)]

    def _lane_handle(flow_j, hist_j):
        """One lane's finalize handle (both mesh loops): the loss curve of
        each scale, then the flow in float32 (whatever the fetch dtype),
        oriented — the single-device finalize's contract."""
        from .solver.api import EstimationHandle

        def _fin():
            if solv.visualizer is not None:
                solv.visualizer.visualize_scipy_history(
                    {f"scale{i}": h.cpu().numpy()
                     for i, h in enumerate(hist_j)})
            solv.iter_cnt += 1
            return solv._orient_flow(flow_j.to(torch.float32).cpu().numpy())

        handle = EstimationHandle(_fin)
        handle.loss_history = hist_j
        return handle

    def _stacked(items, frames_of):
        """The events of ``items`` padded to one capacity and stacked, and
        the frames ``frames_of`` on the solver's device."""
        from .parallel import stack_events
        from .types import pad_events

        cap = max(w["filtered"].capacity for w in items)
        ev_b = stack_events([pad_events(w["filtered"], cap) for w in items])
        frames = torch.as_tensor(np.stack(frames_of)).to(
            device=solv.device, dtype=solv.dtype)
        return ev_b, frames

    def flush_batch(pending):
        """Solve ``pending`` = [(i_frame, work)] in one data-parallel step
        over the mesh (a partial last batch padded with its last frame),
        then finalize each frame in order (rank 0)."""
        with _section("estimate"):
            works = [w for _, w in pending]
            # R inits a frame with restarts (the batched step has R = 1)
            per_frame = solv.spec.n_restarts
            inits = []
            for _ in works:
                inits += _inits(per_frame)
            pad = mesh_B - len(works)
            works_b = works + [works[-1]] * pad
            inits += inits[-per_frame:] * pad
            ev_b, frames = _stacked(works_b, [w["im1"] for w in works_b])
            flows, losses = batched_step(ev_b, frames, solv._mask,
                                         torch.stack(inits))
        if writer:
            for j, (fi, w) in enumerate(pending):
                finalize(w, _lane_handle(flows[j], [h[j] for h in losses]),
                         fi)

    def run_segmented(indices):
        """Sequential mesh mode: split ``indices`` into ``mesh_B``
        contiguous segments, one warm-start chain a data lane; step *t*
        solves frame *t* of every segment in one step, each lane's
        feedback kept on its leader's device.  A collapsed or exhausted
        lane solves a dummy (another lane's frame) whose feedback is gated
        out; the chain resets at each ``time_list`` range.  With
        ``resume`` a lane skips its computed leading frames and restarts
        cold at its first uncomputed one.  Step *t+1* is prepared on the
        host before step *t* is finalized."""
        step_cold, step_warm = seq_steps
        idx = list(indices)
        if not idx:
            return
        base = _next_frame[0]
        _next_frame[0] = base + len(idx)
        bounds = [round(d * len(idx) / mesh_B) for d in range(mesh_B + 1)]
        segments = [idx[bounds[d]:bounds[d + 1]] for d in range(mesh_B)]
        skips = [0] * mesh_B
        if store is not None:
            for d in range(mesh_B):
                while (skips[d] < len(segments[d])
                       and (base + bounds[d] + skips[d]) in store):
                    skips[d] += 1
            if any(skips):
                logger.info(
                    "Resuming sequential mesh: lanes skip %s already-"
                    "computed frames; resumed lanes restart their warm "
                    "chain cold.", skips)
            segments = [s[k:] for s, k in zip(segments, skips)]
        n_steps = max(len(s) for s in segments)

        def _produce_step(t):
            lane_items = []  # (fi, work-or-None) per lane
            for d in range(mesh_B):
                if t < len(segments[d]):
                    fi = base + bounds[d] + skips[d] + t
                    tag, _, work = produce(segments[d][t], fi_override=fi)
                    lane_items.append((fi, work if tag == "work" else None))
                else:
                    lane_items.append((None, None))  # exhausted lane
            return lane_items

        prev, warm = None, False
        lane_items = _produce_step(0)
        for t in range(n_steps):
            dispatched = None
            dummy = next((w for _, w in lane_items if w is not None), None)
            if dummy is not None:  # else: the whole step collapsed
                with _section("estimate"):
                    works = [w if w is not None else dummy
                             for _, w in lane_items]
                    ev_b, frames = _stacked(works, [w["im1"] for w in works])
                    if not warm:
                        flows, prev, losses = step_cold(
                            ev_b, frames, solv._mask,
                            torch.stack(_inits(mesh_B)))
                        warm = True
                    else:
                        flows, prev, losses = step_warm(
                            ev_b, frames, solv._mask, prev,
                            [w is not None for _, w in lane_items])
                dispatched = (lane_items, flows, losses)
            lane_items = _produce_step(t + 1) if t + 1 < n_steps else None
            if dispatched is not None and writer:
                items, flows, losses = dispatched
                for j, (fi, w) in enumerate(items):
                    if w is not None:
                        finalize(w, _lane_handle(
                            flows[j], [h[j] for h in losses]), fi)

    for t_start, t_end in eval_config["time_list"]:
        ind_start = loader.time_to_image_index(t_start) + 1
        ind_end = loader.time_to_image_index(t_end) - eval_dt
        logger.info("Evaluating frames %d..%d", ind_start, ind_end)
        indices = range(ind_start, ind_end)
        if mesh_sequential:
            run_segmented(indices)
            continue
        # one-deep software pipeline: produce(i+1) ‖ solve(i) ‖ finalize(i−1)
        stream = (_prefetched(indices, produce) if pipeline
                  else (produce(i1) for i1 in indices))
        in_flight = None  # (work, handle, i_frame)
        pending = []  # mesh: frames waiting for a full data-parallel step
        for tag, fi, work in stream:
            if tag == "collapsed":
                continue
            if tag == "resumed":
                logger.info("Frame %d already computed — skipping (resume).",
                            fi)
                continue
            if batched_step is not None:
                pending.append((fi, work))
                if len(pending) == mesh_B:
                    flush_batch(pending)
                    pending = []
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
        if pending:
            flush_batch(pending)
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


def mesh_shape(config) -> tuple:
    """``(D, E)`` of the config's ``mesh:`` after its checks (the JAX
    CLI's): the pyramid solver, ``warm_start`` only with ``sequential:
    true`` (which needs it), ``model_image: current``, a power-of-two
    event axis.  Logs what resume and pipeline mean in sequential mode."""
    mesh_cfg = config["mesh"]
    sequential = bool(mesh_cfg.get("sequential"))
    solver = config["solver"]
    if solver.get("method") != "patch_eklt_pyramid2":
        raise ValueError("mesh mode needs the patch_eklt_pyramid2 solver")
    if solver.get("warm_start") and not sequential:
        raise ValueError("warm_start is sequential — incompatible with "
                         "mesh (simultaneous) frame batching; to scale "
                         "the warm-start chain across chips set "
                         "mesh: {sequential: true} (contiguous frame "
                         "segments, one warm chain per data lane)")
    if sequential:
        if not solver.get("warm_start"):
            raise ValueError("mesh: {sequential: true} scales the "
                             "warm-start chain — set solver "
                             "warm_start: true")
        if config.get("resume"):
            logger.info("resume in sequential mesh mode: resumed lanes "
                        "restart their warm chain cold at their first "
                        "uncomputed frame.")
        if config.get("pipeline"):
            logger.info("pipeline: true is implicit in sequential mesh "
                        "mode — the segmented loop overlaps host prep "
                        "with the in-flight device step.")
    if solver.get("generative_ml", {}).get("model_image",
                                           "current") != "current":
        raise ValueError("mesh mode supports model_image: current")
    mesh_e = int(mesh_cfg.get("event", 1))
    if mesh_e < 1 or mesh_e & (mesh_e - 1):
        raise ValueError(f"mesh event axis must be a power of two to "
                         f"divide the padded event buckets, got {mesh_e}")
    return int(mesh_cfg.get("data", 1)), mesh_e


def _computed_frames(directory) -> set:
    """The frame numbers of the resume manifest in ``directory``, read
    without writing (the ranks that do not record)."""
    import json

    from .utils.checkpoint import FrameResultStore

    path = os.path.join(directory, FrameResultStore.MANIFEST)
    try:
        with open(path) as f:
            return {int(k) for k in json.load(f)}
    except (OSError, ValueError):
        return set()


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


def evaluate_flow_on_event_grids(config, loader, viz, device=None):
    """PIV between event histograms instead of the solver (``--eval`` with
    ``estimation_method: openpiv``).

    For each frame of ``time_list`` (every ``dt``-th): two histograms of
    the events in the ``integration_time`` before the frame's time and
    before ``frame_distance`` after it (each one vote, the vote kernel on
    the card), scaled to 255 (and inverted with ``do_inversion``) on the
    host, then the multipass PIV between them on ``device`` (the GPU unless
    the caller asks for another) with the YAML's ``params_openpiv``; the
    flow's color and vector views and both histograms go to the
    Visualizer ``viz``.
    """
    from . import frame_flow
    from .ops.iwe import create_image_from_events
    from .types import events_from_ndarray

    dev = resolve_device(device)
    piv_cfg = config["params_openpiv_events"]
    integration_time = piv_cfg["integration_time"]
    frame_distance = piv_cfg["frame_distance"]
    do_inversion = piv_cfg["do_inversion"]
    eval_config = config["evaluation"]
    eval_dt = eval_config["dt"]
    orig_shape = (config["data"]["height"], config["data"]["width"])
    estimator = frame_flow.FrameFlowEstimator(
        viz, convention=config.get("flow_convention", "reference"),
        device=dev)

    def hist_at(ta, tb):
        e = loader.load_event(max(loader.time_to_index(ta), 0),
                              min(loader.time_to_index(tb), len(loader)))
        ev = events_from_ndarray(e, device=dev)
        h = create_image_from_events(ev, orig_shape, sigma=0).cpu().numpy()
        h = h * (255.0 / max(h.max(), 1e-9))
        return 255.0 - h if do_inversion else h

    for t_start, t_end in eval_config["time_list"]:
        ind_start = loader.time_to_image_index(t_start) + 1
        ind_end = loader.time_to_image_index(t_end) - eval_dt
        for i1 in range(ind_start, ind_end, eval_dt):
            _im1, t1 = loader.load_image(i1)
            hist1 = hist_at(t1 - integration_time, t1)
            hist2 = hist_at(t1 + frame_distance - integration_time,
                            t1 + frame_distance)
            flow, _fig = estimator.consecutive_openpiv(hist1, hist2, config)
            viz.visualize_optical_flow(flow[0], flow[1],
                                       file_prefix="event_flow_openpiv")
            viz.visualize_vector_field(flow, file_prefix="event_flow_vector")
            viz.visualize_image(hist1.astype(np.uint8), file_prefix="hist1")
            viz.visualize_image(hist2.astype(np.uint8), file_prefix="hist2")


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
    ``device`` (the GPU unless the caller asks for another).

    An evaluation with ``mesh: {data: D, event: E}`` and D·E > 1 runs on
    D·E ranks: inside a process group of that size (``torchrun``) this
    process is one of them, otherwise it spawns them and returns when all
    have finished (a failed rank's exception is raised here).  Rank 0
    alone writes.
    """
    import torch.distributed

    from . import data, solver, utils, visualizer
    from .parallel import launch
    from .parallel.mesh import world_size

    dev = resolve_device(device)
    argv = sys.argv[1:] if argv is None else list(argv)
    config, args = utils.parse_args(argv=argv)
    if (args.eval and config.get("mesh")
            and config.get("estimation_method") == "solver"):
        n_ranks = int(np.prod(mesh_shape(config)))
        if n_ranks > 1 and world_size() == 1:
            return launch.run(main, n_ranks, args=(argv, device),
                              device=dev)
    in_group = world_size() > 1
    writer = not in_group or torch.distributed.get_rank() == 0
    if in_group:
        dev = launch.rank_device()
    data_config = config["data"]
    save_dir = config["output_dir"]
    if writer:
        utils.save_config(save_dir, args.config_file, args.log.upper())

    if args.eval:
        assert config["method"] in SUPPORTED_EVALUATION_METHOD
        assert config["estimation_method"] in SUPPORTED_ESTIMATION_METHOD

    if in_group and not writer:
        # rank 0 opens the recording first: a loader may write a cache
        # beside it (the CCS loader's extracted frames)
        torch.distributed.barrier()
    loader = data.collections[data_config["dataset"]](config=data_config)
    loader.set_sequence(data_config["sequence"])
    if in_group and writer:
        loader.load_image(0)
        torch.distributed.barrier()

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
    viz = (None if serving or not writer else
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
        if args.eval and config["estimation_method"] == "openpiv":
            evaluate_flow_on_event_grids(config, loader, viz, device=dev)
        elif args.eval:
            evaluate_per_frames(config, loader, solv, viz, device=dev)
        elif config.get("run_mode") == "accumulate":
            accumulate_sequential(config, loader, solv)
        elif config.get("run_mode") == "sequential_estimate":
            estimate_sequential(config, loader, solv, run_estimation=True)
        else:
            estimate_sequential(config, loader, solv)

    if viz is not None:
        write_videos(viz, solv)

    if args.eval and writer:
        for fname in solv.evaluation_text_list:
            _data, stat = utils.read_flow_error_text(fname)
            logger.info("Evaluation %s:\n%s", fname, stat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
