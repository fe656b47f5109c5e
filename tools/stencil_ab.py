#!/usr/bin/env python3
"""A/B of the CMax stencil kernels against another revision of their source.

    git show REV:event_based_bos_tpu_torch/csrc/cmax_stencil.cu > build/ab.cu
    python3 tools/stencil_ab.py --baseline build/ab.cu [--out FILE]

Builds the port's kernels and the baseline source (same ``nvcc`` flags, a
library of its own under ``build/kernels/``) and prints ``ptxas``' register,
shared-memory and spill lines of both.  Then, at the CMax cell's shapes
(``chip_smoke.py``'s workload: 16 bins over the 720×644 ROI box, R = 2),
both libraries are called through the same ``ctypes`` entry points, with
no launch counted:

* whether the two agree bit for bit, forward and VJP, on five flows:
  N(0, 0.8) drawn per pixel, a smooth one (N(0, 0.8) on a 16-px grid,
  interpolated, as the solve's patch flow is), zero, integer, and shifts
  up to 2R;
* the forward's and the backward's time on the per-pixel and the smooth
  flow, median of 20 CUDA-event runs with L2 flushed (by reading 64 MB,
  as ``chip_smoke.py`` does; and by writing them, as a memset flush does,
  which leaves dirty lines to write back) and with the histograms warm in L2 (as within the Adam loop), in
  turns baseline, current, current, baseline; and the HBM bytes per second
  that the times give (bytes as ``chip_smoke.cmax_bound`` counts them).

Prints one JSON line (also written to ``--out`` when given).  Needs a GPU.
"""

import argparse
import ctypes
import itertools
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

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="a cmax_stencil.cu with the same C entry points, "
                         "or with the earlier ones without the row pitch")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stencil_ab: needs a CUDA device")

    from event_based_bos_tpu_torch import events_from_ndarray, kernels
    from event_based_bos_tpu_torch.ops import cmax_cuda

    libs, ptxas, pitched = {}, {}, {}
    for name, sources in (("baseline", [args.baseline]), ("current", None)):
        built = kernels.build(sources)
        libs[name] = kernels.load(built["path"])
        pitched[name] = (sources is None
                         or "int pitch" in open(args.baseline).read())
        if not pitched[name]:  # the interface without the row pitch
            p, i = ctypes.c_void_p, ctypes.c_int
            libs[name].ebt_cmax_stencil_fwd.argtypes = [p, p, p, i, i, i, i,
                                                        p, p]
            libs[name].ebt_cmax_stencil_bwd.argtypes = [p, p, p, p, i, i, i,
                                                        i, p, p, p]
        ptxas[name] = [line.strip() for line in str(built["log"]).splitlines()
                       if "Compiling entry" in line or "registers" in line
                       or "spill" in line]
        for line in ptxas[name]:
            print(f"{name} ptxas: {line}")

    dev = torch.device("cuda")
    events, _frame, _gt = cs.make_workload()
    ev = events_from_ndarray(events, capacity=cs.CAPACITY, device=dev)
    hists, dts = cs.box_histograms(ev, cs.cmax_cell_spec())
    b, h, w = hists.shape
    r = cs.CMAX_RADIUS
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.uniform(0, 1, (h, w)), dtype=torch.float32,
                        device=dev)
    reach = 2 * r / float(dts.abs().max())
    coarse = torch.as_tensor(rng.normal(0, 0.8, (1, 2, h // 16 + 1,
                                                 w // 16 + 1)))
    flows = {"N(0,0.8)": rng.normal(0, 0.8, (2, h, w)),
             "smooth": torch.nn.functional.interpolate(
                 coarse, size=(h, w), mode="bilinear",
                 align_corners=True)[0].numpy(),
             "zero": np.zeros((2, h, w)),
             "integer": rng.integers(-3, 4, (2, h, w)),
             "shifts to 2R": rng.uniform(-reach, reach, (2, h, w))}
    flows = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
             for k, v in flows.items()}

    def call(name, fl, backward):
        lib = libs[name]
        stream = torch.cuda.current_stream().cuda_stream
        shape = (b, h, w, w) if pitched[name] else (b, h, w)
        if backward:
            out = torch.empty((2, h, w), dtype=torch.float32, device=dev)
            err = lib.ebt_cmax_stencil_bwd(
                hists.data_ptr(), fl.data_ptr(), g.data_ptr(),
                dts.data_ptr(), *shape, r, out[0].data_ptr(),
                out[1].data_ptr(), stream)
        else:
            out = torch.empty((h, w), dtype=torch.float32, device=dev)
            err = lib.ebt_cmax_stencil_fwd(
                hists.data_ptr(), fl.data_ptr(), dts.data_ptr(), *shape, r,
                out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"launch failed (cudaError {err})")
        return out

    agree = {}
    for fname, fl in flows.items():
        for backward in (False, True):
            got = {k: call(k, fl, backward) for k in libs}
            plain = (torch.stack(cmax_cuda.binned_warp_accumulate_plain_bwd(
                hists, fl, dts, g, r)) if backward else
                cmax_cuda.binned_warp_accumulate_plain_fwd(hists, fl, dts,
                                                           r))
            torch.cuda.synchronize()
            key = f"{fname} {'VJP' if backward else 'forward'}"
            agree[key] = {
                "bit_identical": torch.equal(got["baseline"], got["current"]),
                "max_abs_diff": float((got["baseline"]
                                       - got["current"]).abs().max()),
                **{f"{k}_rel_vs_plain": float(
                    (v - plain).abs().max() / (plain.abs().max() + 1e-12))
                   for k, v in got.items()}}
            print(f"{key}: {agree[key]}")

    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    flushes = {"L2 flushed": cs.l2_flush(dev),
               "L2 flushed by writes": flush_buf.zero_, "L2 warm": None}
    times = {}
    for (fname, fl), backward, (mode, flush) in itertools.product(
            [(k, flows[k]) for k in ("N(0,0.8)", "smooth")], (False, True),
            flushes.items()):
        nbytes = cs.cmax_bound(hists, fl, dts, r, backward)[2]
        runs = {"baseline": [], "current": []}
        for name in ("baseline", "current", "current", "baseline"):
            runs[name].append(cs.cuda_ms(
                lambda name=name: call(name, fl, backward), flush=flush))
        key = f"{fname} {'bwd' if backward else 'fwd'} {mode}"
        times[key] = {k: {"ms": v, "median_ms": statistics.median(v),
                          "hbm_GBps": nbytes / statistics.median(v)
                          / 1e6} for k, v in runs.items()}
        print(f"{key}: " + ", ".join(
            f"{k} {v['median_ms']:.4f} ms ({v['ms'][0]:.4f}, "
            f"{v['ms'][1]:.4f})" for k, v in times[key].items()))
    out = {"device": torch.cuda.get_device_name(0), "card": cs.card_line(),
           "shape": [b, h, w], "radius": r, "ptxas": ptxas,
           "agreement": agree, "times": times}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
