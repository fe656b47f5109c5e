#!/usr/bin/env python3
"""Probe of the PyTorch port's solve paths on a GPU.

    python3 tools/torch_solve_probe.py
        [--path pyramid|cmax|gml|patch|dependent] [--seeds 8]
        [--restrict [--roi-norm-stride 4]]
        [--compute-dtype bfloat16|float32] [--out FILE]

On the ``chip_smoke.py`` workload (720×1280, 2^19 events), after one
warm-up frame, for ``--path pyramid`` (the main path: 64→8 patches, 600
iterations) or ``--path cmax`` (the CMax cell: ``CmaxSpec``'s defaults with
the bench ROI, 260 Adam steps); ``--restrict`` solves the pyramid on the
margin-expanded ROI box (``restrict_to_roi``, outside-norm stride
``--roi-norm-stride``) and ``--compute-dtype`` runs its objective's
interior in that dtype.  ``--path gml``, ``patch`` and ``dependent`` solve
``chip_smoke.py``'s phase-11 scene (720×1280, uniform displacement, 2^19
events) with phase 11's specs: GML with Adam (600 steps, 4 parameters),
PatchEklt and PatchEkltDependent at the facade's defaults (4/2 patches,
600 Adam steps).  Per path:

* the accuracy and ms/frame (CUDA events) over ``--seeds`` frames — EPE
  against the synthetic ground truth for the pyramid (random
  initializations, ``torch.Generator(...).manual_seed``) and CMax (from
  flow 0, so its frames repeat); for the other solvers the mean flow's
  cosine with the scene's −du (the joint solver's poisson init drawn from
  the seed);
* one frame under ``torch.profiler``: CUDA kernels launched (per frame and
  per Adam step), their summed device time, the device's idle share of an
  unprofiled frame, the kernels that take the most device time, and the
  port's own kernels (``csrc/*.cu``) with their in-loop time per launch.

Prints one JSON line (also written to ``--out`` when given).  Needs a GPU.
"""

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main(argv=None):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("pyramid", "cmax", "gml", "patch",
                                       "dependent"), default="pyramid")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--restrict", action="store_true",
                    help="pyramid: restrict_to_roi")
    ap.add_argument("--roi-norm-stride", type=int, default=4)
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"),
                    default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_solve_probe: needs a CUDA device")

    from event_based_bos_tpu_torch import events_from_ndarray
    from event_based_bos_tpu_torch.solver import (
        GenerativeSpec, PyramidSpec, cmax, estimate_frame_cmax,
        estimate_frame_dependent, estimate_frame_gml, estimate_frame_patch,
        facades)
    from event_based_bos_tpu_torch.solver.generative import iwe_cache
    from event_based_bos_tpu_torch.solver.pyramid import (estimate_frame,
                                                          roi_mask,
                                                          scale_iterations)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    events, frame, gt_flow = cs.make_workload()
    gen = GenerativeSpec(image_size=(cs.H, cs.W), iwe_sigma=2.0,
                         weight_by_inverse_event_hist=True,
                         optimize_warp=True, poisson_model=True,
                         compute_dtype=getattr(torch, args.compute_dtype)
                         if args.compute_dtype else None)
    spec = PyramidSpec(gen=gen, roi=cs.ROI, coarsest_patch=64,
                       finest_patch=8, n_iter=cs.N_ITER,
                       restrict_to_roi=args.restrict,
                       roi_norm_stride=args.roi_norm_stride)
    ev = events_from_ndarray(events, capacity=cs.CAPACITY, device=dev)
    frame_t = torch.as_tensor(frame, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(roi_mask(spec), device=dev)
    if args.path == "cmax":
        cspec = cs.cmax_cell_spec()
        steps = sum(cmax.scale_iterations(cspec))
        epe_of = cs.cmax_epe

        def solve(_seed):
            return estimate_frame_cmax(ev, None, None, cspec, device=dev)[0]
    elif args.path in ("gml", "patch", "dependent"):
        frame, scene = cs.other_solvers_scene()
        ev = events_from_ndarray(scene, capacity=cs.CAPACITY, device=dev)
        frame_t = torch.as_tensor(frame, dtype=torch.float32, device=dev)
        steps = cs.N_ITER

        def epe_of(flow, _gt):
            return cs.direction_cosine(flow)

        if args.path == "gml":
            gspec = cs.gml_spec("Adam", cs.N_ITER)
            x0 = torch.tensor([0.1, -0.1, 0.0, 0.0], device=dev)

            def solve(_seed):
                return estimate_frame_gml(ev, frame_t, None, gspec, x0=x0,
                                          device=dev)[0]
        else:
            method = {"patch": "patch_eklt",
                      "dependent": "patch_eklt_dependent"}[args.path]
            pspec = facades.collections[method](
                (cs.H, cs.W), (cs.H, cs.W),
                solver_config=cs.other_solver_config(method),
                device=dev).spec
            estimator = {"patch": estimate_frame_patch,
                         "dependent": estimate_frame_dependent}[args.path]

            def solve(seed):
                return estimator(ev, frame_t,
                                 torch.Generator(dev).manual_seed(seed),
                                 pspec, device=dev)[0]
    else:
        steps = sum(scale_iterations(spec))
        epe_of = cs.accuracy_epe

        def solve(seed):
            cache = iwe_cache(ev, gen)
            return estimate_frame(None, frame_t, mask,
                                  torch.Generator(dev).manual_seed(seed),
                                  spec, cache=cache, device=dev)[0]

    solve(0)
    torch.cuda.synchronize()
    epe, ms = [], []
    for seed in range(args.seeds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        flow = solve(seed)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        epe.append(epe_of(flow.cpu().numpy(), gt_flow))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve(0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    own = {name: {"count": n, "ms": t, "ms_per_launch": t / n}
           for name, (n, t) in by_name.items()
           if "cmax_stencil_kernel" in name or "hat_vote_kernel" in name}
    frame_ms = statistics.median(ms)
    out = {
        "device": torch.cuda.get_device_name(0),
        "card": cs.card_line(),
        "path": args.path,
        "restrict_to_roi": args.restrict,
        "roi_norm_stride": args.roi_norm_stride if args.restrict else None,
        "compute_dtype": args.compute_dtype,
        "seeds": args.seeds,
        "accuracy_metric": ("cosine with -du" if args.path in (
            "gml", "patch", "dependent") else "EPE px"),
        "epe_px": epe,
        "epe_median_px": statistics.median(epe),
        "epe_zero_flow_px": epe_of(np.zeros((2, cs.H, cs.W)), gt_flow),
        "frame_ms": ms,
        "frame_ms_median": frame_ms,
        "adam_steps_per_frame": steps,
        "ms_per_step": frame_ms / steps,
        "kernels_per_frame": len(kernels),
        "kernels_per_step": len(kernels) / steps,
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": 1.0 - busy_ms / frame_ms,
        "top_kernels": [{"name": name[:90], "count": n, "ms": t}
                        for name, (n, t) in top],
        "port_kernels": own,
    }
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
