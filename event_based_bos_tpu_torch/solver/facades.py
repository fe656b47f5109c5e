"""Concrete solver facades and the registry the CLI reads.

PyTorch counterpart of the JAX package's ``solver/facades.py``: the
whole-ROI solver (``generative_max_likelihood``), the tiled solvers
(``patch_eklt``, ``patch_eklt_dependent``), the pyramid
(``patch_eklt_pyramid2``, the serving path) and CMax
(``contrast_maximization``) over the port's per-frame estimators.  Each
votes the IWE cache (or CMax's histograms) once a frame on the card.

Each facade keeps its programs per event capacity in ``self._programs``,
as the JAX package's facades keep one jitted solve per capacity: on the
card a capacity's first frame captures its program (the IWE cache or
CMax's histograms, and the method's loop: each first-order, Nelder-Mead or
Newton-CG step, each L-BFGS iteration with its line search, a sampler's
trials) and every later frame copies its inputs into the program's buffers
and replays.  Only GML's sequential TPE study, driven from the host as in
the JAX package, keeps no program.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..types import Events
from ..utils.tracing import span
from .api import EstimationHandle, SolverBase, fetch_later
from .cmax import CmaxProgram, CmaxSpec, estimate_frame_cmax
from .generative import (GenerativeSpec, initialize_params, iwe_cache,
                         iwe_cache_from_votes, iwe_cache_program)
from .gml import (GmlProgram, GmlSpec, estimate_frame_gml,
                  make_host_tpe_solver)
from .patch import (PatchProgram, PatchSpec, estimate_frame_dependent,
                    estimate_frame_patch)
from .pyramid import (PyramidSpec, SolveProgram, estimate_frame,
                      pyramid_grids, roi_mask, update_coarse_from_fine)

logger = logging.getLogger(__name__)

__all__ = ["GenerativeMaximumLikelihood", "PatchEklt", "PatchEkltDependent",
           "PatchEkltPyramid2", "ContrastMaximization", "collections"]


def _kept(programs: dict, key, make, n_iter: int):
    """The program under ``key`` in ``programs``, made by ``make()`` (and
    logged) at its capacity's first frame."""
    if key not in programs:
        capacity = key[0] if isinstance(key, tuple) else key
        logger.info(
            "Capturing the solve program for event capacity %d (%d "
            "iterations) — its first frame includes the capture; later "
            "frames replay it.", capacity, n_iter)
        programs[key] = make()
    return programs[key]


def _evolution_stride(solver_config, n_iter: int) -> int:
    """Iterate-recording stride of the DEBUG evolution videos: the
    ``record_evolution`` key (0 = off, n = every n-th iterate), else, at
    DEBUG log level, a stride that caps the video at ~120 frames."""
    if "record_evolution" in (solver_config or {}):
        return int(solver_config["record_evolution"])
    if logger.isEnabledFor(logging.DEBUG):
        return max(1, n_iter // 120)
    return 0


def _generative_spec(orig_image_shape, solver_config, dtype
                     ) -> GenerativeSpec:
    """The generative model's spec from the ``generative_ml`` section and
    the cost weights, with the JAX package's defaults.  ``compute_dtype:
    bfloat16`` or ``float32`` runs the objective's interior in that dtype
    (``float32`` also at ``precision: 64``); any other value leaves it in
    the solve's dtype."""
    g = solver_config.get("generative_ml", {})
    cw = solver_config.get("cost_with_weight", {"diff_norm": 1.0})
    compute_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                     None: None}.get(solver_config.get("compute_dtype"))
    return GenerativeSpec(
        warp_stencil_radius=int(solver_config.get("warp_stencil_radius", 1)),
        compute_dtype=compute_dtype,
        warp_compute_bf16=bool(solver_config.get("warp_compute_bf16",
                                                 False)),
        image_size=tuple(orig_image_shape),
        no_polarity=bool(g.get("no_polarity", False)),
        iwe_sigma=float(g.get("iwe_sigma", 0) or 0),
        weight_by_event_hist=bool(g.get("weight_loss_by_event_hist", False)),
        weight_sigma=float(g.get("weight_sigma", 5)),
        weight_by_inverse_event_hist=bool(
            g.get("weight_loss_by_inverse_event_hist", False)),
        optimize_warp=bool(g.get("optimize_warp", False)),
        pxpy_as_anglemagn=bool(g.get("px-py_as-angle-magnitude", False)),
        angle_model=bool(g.get("angle_model", False)),
        poisson_model=bool(g.get("poisson_model", False)),
        use_log_intensity=bool(g.get("use_log_intensity", False)),
        sobel_ksize=int(g.get("sobel_ksize", 3)),
        cost_weights=tuple(cw.items()),
        dtype=dtype,
    )


class GenerativeMaximumLikelihood(SolverBase):
    """Whole-ROI solver facade: one constant flow over the image.

    ``optimizer.method`` names the optimizer (``optuna`` reads
    ``optimizer.sampler``); the samplers' boxes are
    ``optimizer.parameters``.  ``TPE`` runs the sequential study from the
    host (one evaluation and one read a trial), its seed drawn from the
    facade's generator in :meth:`estimate_async`.  The learning rate is the
    solver's own (0.01), as in the JAX package.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        opt = self.slv_config.get("optimizer", {})
        self.gen = _generative_spec(self.orig_image_shape, self.slv_config,
                                    self.dtype)
        bounds = tuple((float(v["min"]), float(v["max"]))
                       for v in opt.get("parameters", {}).values())
        method = opt.get("method", "Adam")
        if method == "optuna":
            method = opt.get("sampler", method)
        n_iter = int(opt.get("n_iter", 600))
        self.spec = GmlSpec(
            gen=self.gen,
            roi=(self.crop_xmin, self.crop_xmax, self.crop_ymin,
                 self.crop_ymax),
            method=method, n_iter=n_iter, param_bounds=bounds,
            record_evolution=_evolution_stride(self.slv_config, n_iter))
        self._tpe_solver = (make_host_tpe_solver(self.spec, self.device)
                            if method == "TPE" else None)
        self._programs = {}

    def _program(self, capacity: int):
        """The kept program of event capacity ``capacity`` (every method
        but the host-driven TPE study)."""
        if self._tpe_solver is not None:
            return None
        return _kept(self._programs, capacity,
                     lambda: GmlProgram(self.spec), self.spec.n_iter)

    def estimate_async(self, events, *args, **kwargs) -> EstimationHandle:
        """Queue the IWE cache and the solve (the TPE study runs here, on
        the host); the handle's ``result()`` fetches the flow and, with a
        visualizer, plots the loss curve and the recorded evolution."""
        with span("ebt.estimate"):
            ev = self._to_events(events)
            frame = self._frame(kwargs)
            if self._tpe_solver is not None:
                seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                         generator=self._generator,
                                         device=self.device))
                flow, aux = self._tpe_solver(ev, frame, seed)
            else:
                flow, aux = estimate_frame_gml(
                    ev, frame, self._generator, self.spec,
                    device=self.device, program=self._program(ev.capacity))
            fetch = fetch_later([flow, aux["history"]])

        def finalize() -> np.ndarray:
            flow_h, history = fetch()
            if self.visualizer is not None:
                self.visualizer.visualize_scipy_history(
                    {"loss": history.numpy()})
                if "theta_history" in aux:
                    from .evolution import render_gml_evolution

                    render_gml_evolution(self.visualizer, frame, ev, aux,
                                         self.spec, self.iter_cnt,
                                         diff_scale=self._viz_diff_scale())
            self.iter_cnt += 1
            return self._orient_flow(flow_h.numpy())

        self.dispatch_cnt += 1
        handle = EstimationHandle(finalize)
        handle.loss_history = [aux["history"]]
        handle.host_reads = aux.get("host_reads", 0) + (
            self._tpe_solver is not None)  # the TPE seed's draw
        return handle


class PatchEklt(SolverBase):
    """Independent tiled solver facade: every patch of the
    ``patch_eklt.patch_size`` / ``sliding_window`` grid fitted on its own,
    all patches in one batch (``optimizer.method`` a first-order name; the
    learning rate is the solver's own, 0.01)."""

    JOINT = False  # the kind of its programs

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        opt = self.slv_config.get("optimizer", {})
        pe = self.slv_config.get("patch_eklt", {})
        self.gen = _generative_spec(self.orig_image_shape, self.slv_config,
                                    self.dtype)
        self.spec = PatchSpec(
            gen=self.gen,
            roi=(self.crop_xmin, self.crop_xmax, self.crop_ymin,
                 self.crop_ymax),
            patch_size=int(pe.get("patch_size", 4)),
            sliding_window=int(pe.get("sliding_window",
                                      pe.get("patch_size", 4))),
            method=opt.get("method", "Adam"),
            n_iter=int(opt.get("n_iter", 600)),
            do_event_thresholding=bool(pe.get("do_event_thresholding",
                                              False)),
            event_thres=int(pe.get("event_thres", 8)),
        )
        self._programs = {}

    def _program(self, capacity: int) -> PatchProgram:
        """The kept program of event capacity ``capacity``."""
        return _kept(self._programs, capacity,
                     lambda: PatchProgram(self.spec, joint=self.JOINT),
                     self.spec.n_iter)

    def _solve(self, ev, frame):
        return estimate_frame_patch(ev, frame, self._generator, self.spec,
                                    device=self.device,
                                    program=self._program(ev.capacity))

    def estimate_async(self, events, *args, **kwargs) -> EstimationHandle:
        """Queue the IWE cache and the solve; the handle's
        ``loss_history`` holds one ``[n_iter]`` history, a copy of this
        frame's: each step's loss summed over the active patches (the
        joint solve: its loss)."""
        with span("ebt.estimate"):
            ev = self._to_events(events)
            flow, aux = self._solve(ev, self._frame(kwargs))
            fetch = fetch_later([flow])

        def finalize() -> np.ndarray:
            self.iter_cnt += 1
            return self._orient_flow(fetch()[0].numpy())

        self.dispatch_cnt += 1
        handle = EstimationHandle(finalize)
        handle.loss_history = [aux["history"]]
        return handle


class PatchEkltDependent(PatchEklt):
    """Joint tiled solver facade: the whole patch field in one solve, at
    learning rate 0.05; the poisson model's init is drawn from the
    facade's generator."""

    JOINT = True

    def _solve(self, ev, frame):
        return estimate_frame_dependent(ev, frame, self._generator,
                                        self.spec, device=self.device,
                                        program=self._program(ev.capacity))


class PatchEkltPyramid2(SolverBase):
    """Coarse-to-fine pyramid facade — the flagship solver.

    Each frame votes the IWE cache (one launch of the vote kernel on the
    card) as its own step, then solves; this is the JAX package's
    ``split_iwe_cache`` arrangement, which gives the same numbers as its
    fused one, so every mode name is accepted.  The flow's ROI box is
    fetched and the full frame rebuilt around it on the host (the solve
    writes exact +0.0 outside the ROI); ``handle.device_flow`` keeps the
    full-frame unoriented flow on the device for the error pair and FWL.

    The options ``restrict_to_roi`` (``roi_margin``, ``roi_norm_stride``),
    ``n_restarts`` (``restart_mode``), ``compute_dtype`` and
    ``warp_compute_bf16`` are validated as in the JAX package.  With
    ``n_restarts: R`` the facade's generator draws the R coarsest-scale
    inits in lane order inside :meth:`estimate_async`, before the first
    lane runs, so the pipelined loop stays bit-identical to the
    synchronous one.

    ``flow_fetch_dtype: float16`` / ``bfloat16`` casts the flow on the
    device before the ROI box is fetched (the host gets float32 back);
    ``handle.device_flow`` is then the cast full-frame flow.  The solve
    reads events only through the polarity histogram, so an array uploads
    without timestamps (the t-less wire, 5 B/event).

    The facade keeps one :class:`~.pyramid.SolveProgram` per event capacity
    and schedule (the full ``n_iter``, and ``steady_n_iter`` for the warm
    frames when it is set), as the JAX package keeps one jitted solve per
    pair, and one IWE-cache program per capacity
    (:func:`~.generative.iwe_cache_program`, the JAX package's
    ``_cache_fn``): on the card a capacity's first frame captures the cache
    and each scale's step, and later frames replay them.  :meth:`prewarm`
    captures them ahead of the first frame.
    """

    SUPPORTS_FLOW_FETCH_DTYPE = True
    EVENTS_NEED_T = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        opt = self.slv_config.get("optimizer", {})
        pe = self.slv_config.get("patch_eklt", {})
        self.gen = _generative_spec(self.orig_image_shape, self.slv_config,
                                    self.dtype)
        self.spec = PyramidSpec(
            gen=self.gen,
            roi=(self.crop_xmin, self.crop_xmax, self.crop_ymin,
                 self.crop_ymax),
            coarsest_patch=int(pe.get("coarsest_patch_size", 64)),
            finest_patch=int(pe.get("finest_patch_size", 8)),
            n_iter=int(opt.get("n_iter", 600)),
            method=opt.get("method", "Adam"),
            lr=float(opt.get("lr", 0.05)),
            lr_decay=float(opt.get("lr_decay", 0.1)),
            track_best=bool(self.slv_config.get("track_best", True)),
            restrict_to_roi=bool(self.slv_config.get("restrict_to_roi",
                                                     False)),
            roi_margin=int(self.slv_config.get("roi_margin", 2)),
            roi_norm_stride=int(self.slv_config.get("roi_norm_stride", 4)),
            record_evolution=_evolution_stride(self.slv_config,
                                               int(opt.get("n_iter", 600))),
            n_restarts=int(self.slv_config.get("n_restarts", 1)),
            restart_mode=str(self.slv_config.get("restart_mode", "map")),
        )
        warm = bool(self.slv_config.get("warm_start"))
        if self.spec.restart_mode not in ("map", "vmap"):
            raise ValueError("restart_mode must be 'map' (sequential lanes, "
                             "~R× one solve) or 'vmap' (batched lanes), got "
                             f"{self.spec.restart_mode!r}")
        if self.spec.restrict_to_roi and self.spec.roi_margin < 2:
            raise ValueError(
                "restrict_to_roi requires roi_margin >= 2 (got "
                f"{self.spec.roi_margin}): the full-frame cost equivalence "
                "needs the ROI mask ridge and its difference stencil inside "
                "the cropped box.")
        if self.spec.n_restarts > 1 and warm:
            raise ValueError("n_restarts > 1 is a cold-start feature; it "
                             "does not compose with warm_start (all "
                             "restarts would share the warm init).")
        steady = self.slv_config.get("steady_n_iter")
        if steady is not None:
            # warm-started frames may run a shorter schedule; frame 0 keeps
            # the full n_iter
            steady = int(steady)
            if not warm:
                raise ValueError(
                    "steady_n_iter requires warm_start: true — it shortens "
                    "only warm-started frames; without warm starts every "
                    "frame is cold and must run the full n_iter.")
            if steady < 1:
                raise ValueError(f"steady_n_iter must be >= 1, got {steady}")
            self.spec_steady = dataclasses.replace(
                self.spec, n_iter=steady,
                record_evolution=_evolution_stride(self.slv_config, steady))
        else:
            self.spec_steady = None
        sic = self.slv_config.get("split_iwe_cache", "auto")
        if sic not in ("auto", False, "off", "scatter", "pallas"):
            raise ValueError(
                f"split_iwe_cache: unknown mode {sic!r} (expected 'auto', "
                "false, 'scatter' or 'pallas')")
        self._warm_start = warm
        self._mask = torch.as_tensor(roi_mask(self.spec), device=self.device)
        x0, x1, y0, y1 = self.spec.roi
        h, w = self.gen.image_size
        self._flow_fetch_box = ((x0, x1, y0, y1)
                                if (x1 - x0) * (y1 - y0) < h * w else None)
        self._programs = {}
        self._cache_programs = {}

    def _program(self, capacity: int, steady: bool = False) -> SolveProgram:
        """The solve program of event capacity ``capacity`` for the full
        schedule or (``steady``) the warm frames' ``steady_n_iter``."""
        spec = self.spec_steady if steady else self.spec
        return _kept(self._programs, (capacity, steady),
                     lambda: SolveProgram(spec), spec.n_iter)

    def _cache_program(self, capacity: int):
        """The IWE-cache program of event capacity ``capacity``."""
        if capacity not in self._cache_programs:
            self._cache_programs[capacity] = iwe_cache_program(self.gen)
        return self._cache_programs[capacity]

    def prewarm(self, capacity: int) -> None:
        """Build the kernels and capture the IWE-cache and solve programs
        of ``capacity`` ahead of the first frame, as the JAX package
        compiles and dispatches its programs on an all-invalid dummy batch:
        the cache of such a batch (one vote), and one solve on an all-zero
        IWE cache from a start drawn from a generator of its own, so the
        solver's generator, and every real frame's output, are unchanged.
        With ``steady_n_iter`` the warm frames' program is captured too,
        from the dummy solve's feedback."""
        super().prewarm(capacity)
        dev = self.device
        size = tuple(self.orig_image_shape)
        zeros = torch.zeros((capacity,), dtype=self.dtype, device=dev)
        iwe_cache(Events(zeros, zeros, zeros, zeros,
                         torch.zeros((capacity,), dtype=torch.bool,
                                     device=dev)),
                  self.gen, self._cache_program(capacity))
        cache = iwe_cache_from_votes(
            torch.zeros((2,) + size, dtype=self.dtype, device=dev), self.gen)
        frame = torch.zeros(size, dtype=self.dtype, device=dev)
        start = initialize_params(torch.Generator(dev).manual_seed(0),
                                  pyramid_grids(self.spec)[0].shape,
                                  self.gen, dev)
        _flow, aux = estimate_frame(None, frame, self._mask, None, self.spec,
                                    init_params=start, cache=cache,
                                    device=dev,
                                    program=self._program(capacity))
        if self.spec_steady is not None:
            prev = update_coarse_from_fine(aux["params_per_scale"], self.spec)
            estimate_frame(None, frame, self._mask, None, self.spec_steady,
                           prev_params=prev, cache=cache, device=dev,
                           program=self._program(capacity, steady=True))

    def estimate_async(self, events, *args, **kwargs) -> EstimationHandle:
        """Queue the IWE cache and the pyramid solve (and the warm-start
        feedback for the next frame); the returned handle's ``result()``
        waits for the flow's ROI box and rebuilds the full frame, and with
        a visualizer plots the loss curve of each scale (and the recorded
        evolution, :mod:`.evolution`)."""
        with span("ebt.estimate"):
            ev = self._to_events(events, need_t=False)
            frame = self._frame(kwargs)
            prev = self.previous_frame_best_estimation
            steady = self.spec_steady is not None and prev is not None
            used_spec = self.spec_steady if steady else self.spec
            cache = iwe_cache(ev, self.gen, self._cache_program(ev.capacity))
            flow, aux = estimate_frame(
                None, frame, self._mask, self._generator, used_spec,
                prev_params=prev, cache=cache, device=self.device,
                program=self._program(ev.capacity, steady))
            if self._fetch_dtype is not None:
                flow = flow.to(self._fetch_dtype)
            box = self._flow_fetch_box
            fetch = fetch_later([flow if box is None
                                 else flow[:, box[0]:box[1], box[2]:box[3]]])
            if self._warm_start:
                self.set_previous_frame_best_estimation(
                    update_coarse_from_fine(aux["params_per_scale"],
                                            used_spec))

        def finalize() -> np.ndarray:
            if self.visualizer is not None:
                self.visualizer.visualize_scipy_history(
                    {f"scale{i}": h.detach().cpu().numpy()
                     for i, h in enumerate(aux["loss_history"])})
                if "params_history" in aux:
                    from .evolution import render_pyramid_evolution

                    render_pyramid_evolution(self.visualizer, frame, ev, aux,
                                             used_spec, self.iter_cnt,
                                             diff_scale=self._viz_diff_scale())
            self.iter_cnt += 1
            arr = fetch()[0].to(torch.float32).numpy()
            if box is not None:
                # the solve writes exact +0.0 outside the ROI, so the
                # rebuilt frame equals the full flow bit for bit
                full = np.zeros((2,) + tuple(self.orig_image_shape),
                                np.float32)
                full[:, box[0]:box[1], box[2]:box[3]] = arr
                arr = full
            return self._orient_flow(arr)

        self.dispatch_cnt += 1
        handle = EstimationHandle(finalize)
        handle.device_flow = flow
        handle.loss_history = aux["loss_history"]
        return handle


class ContrastMaximization(SolverBase):
    """CMax solver facade (events-only flow).

    Config: the ``solver.cmax`` section's ``contrast_weights``,
    ``smoothness`` and ``iwe_sigma``; ``motion_model``, ``warp_direction``,
    ``optimizer`` and the ``patch_eklt`` patch sizes reuse the common keys.
    The rest of :class:`CmaxSpec` keeps its defaults, as in the JAX package.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        opt = self.slv_config.get("optimizer", {})
        cm = self.slv_config.get("cmax", {})
        pe = self.slv_config.get("patch_eklt", {})
        cw = cm.get("contrast_weights", {"image_variance": 1.0})
        bounds = tuple(
            (float(v["min"]), float(v["max"]))
            for v in opt.get("parameters", {}).values()) or ((-30, 30),) * 2
        self.spec = CmaxSpec(
            image_size=self.orig_image_shape,
            roi=(self.crop_xmin, self.crop_xmax, self.crop_ymin,
                 self.crop_ymax),
            motion_model=self.slv_config.get("motion_model", "dense-flow"),
            contrast_weights=tuple(cw.items()),
            smoothness=float(cm.get("smoothness", 0.01)),
            iwe_sigma=float(cm.get("iwe_sigma", 1.0)),
            direction=self.slv_config.get("warp_direction", "middle"),
            coarsest_patch=int(pe.get("coarsest_patch_size", 64)),
            finest_patch=int(pe.get("finest_patch_size", 16)),
            n_iter=int(opt.get("n_iter", 240)),
            method=opt.get("method", "Adam"),
            lr=float(opt.get("lr", 0.05)),
            param_bounds=bounds,
            dtype=self.dtype,
        )
        self._programs = {}

    def _program(self, capacity: int):
        """The kept program of event capacity ``capacity`` (every motion
        model and method)."""
        return _kept(self._programs, capacity,
                     lambda: CmaxProgram(self.spec), self.spec.n_iter)

    def estimate_async(self, events, *args, **kwargs) -> EstimationHandle:
        with span("ebt.estimate"):
            ev = self._to_events(events)
            flow, aux = estimate_frame_cmax(
                ev, None, self._generator, self.spec, device=self.device,
                program=self._program(ev.capacity))
            fetch = fetch_later([flow])

        def finalize() -> np.ndarray:
            self.iter_cnt += 1
            # the CMax flow is already the pattern displacement: the
            # orientation convention does not apply
            return np.ascontiguousarray(fetch()[0].numpy())

        self.dispatch_cnt += 1
        handle = EstimationHandle(finalize)
        # the dense solve's per-scale histories, the translation's one
        handle.loss_history = aux.get("loss_history", [aux.get("history")])
        return handle


collections = {
    "generative_max_likelihood": GenerativeMaximumLikelihood,
    "patch_eklt": PatchEklt,
    "patch_eklt_dependent": PatchEkltDependent,
    "patch_eklt_pyramid2": PatchEkltPyramid2,
    "contrast_maximization": ContrastMaximization,
}
