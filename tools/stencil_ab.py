#!/usr/bin/env python3
"""A/B of the port's CUDA kernels against another revision of their source.

    git show REV:event_based_bos_tpu_torch/csrc/cmax_stencil.cu > build/ab.cu
    python3 tools/stencil_ab.py --baseline build/ab.cu [--out FILE]
    python3 tools/stencil_ab.py --kernel vote [--baseline FILE.cu] [--out FILE]

Builds the port's kernels and the baseline source (same ``nvcc`` flags, a
library of its own under ``build/kernels/``) and prints ``ptxas``' register,
shared-memory and spill lines.  Every time is the median of 20 CUDA-event
spans of device time (``chip_smoke.cuda_ms``), timed in turns baseline,
current, current, baseline; no launch is counted.

``--kernel stencil`` (the default): the CMax stencil kernels at the CMax
cell's shapes (``chip_smoke.py``'s workload: 16 bins over the 720×644 ROI
box, R = 2), both libraries called through the same ``ctypes`` entry
points:

* whether the two agree bit for bit, forward and VJP, on five flows:
  N(0, 0.8) drawn per pixel, a smooth one (N(0, 0.8) on a 16-px grid,
  interpolated, as the solve's patch flow is), zero, integer, and shifts
  up to 2R;
* the forward's and the backward's time on the per-pixel and the smooth
  flow, with L2 flushed (by reading 64 MB, as ``chip_smoke.py`` does; and
  by writing them, as a memset flush does, which leaves dirty lines to
  write back) and with the histograms warm in L2 (as within the Adam
  loop); and the HBM bytes per second that the times give (bytes as
  ``chip_smoke.cmax_bound`` counts them).

``--kernel vote``: the event vote at the main path's shapes (2^19 events
of the workload, 720×1280), with L2 flushed by reading:

* against the one-thread-per-event atomic design as the PR 1–3 wrappers
  called it (``tools/hat_vote_atomic.cu`` by default, entry
  ``ebt_hat_vote``; its wrapper prepared ``x``, ``y``, ``v`` from the
  event record and zeroed the image first): that design's parts
  (``torch.zeros`` of the image alone, the kernel alone onto an image
  zeroed beforehand, the kernel with every ``atomicAdd`` turned into a
  store that never happens — the source rewritten under ``build/`` — and
  the preparation alone), then bare vote, events sorted by pixel, a skewed
  input (all 2^19 events in one 32×32 window), signed cache vote and the
  16-bin CMax histograms into the 720×644 box (baseline: the per-bin torch
  scatter, crop and pitched copy), with whether the two agree bit for bit;
  for the histograms also a CUDA-event span around the call as the host
  issues it and the device time that the profiler sums;
* against the per-tile design (``tools/hat_vote_tiled.cu``, entry
  ``ebt_vote_tiled``: count, place and accumulate launches over
  shared-memory tiles) and each ``--variant`` source with the package's
  entry ``ebt_vote`` (called through the package's wrappers), on the bare,
  signed, skewed and 16-bin box votes: bit-equality and times in turns;
  each design's device time by kernel; with ``--sweep`` the per-tile
  design over tile shapes and chunk lengths.

Prints one JSON line (also written to ``--out`` when given).  Needs a GPU.
"""

import argparse
import ctypes
import functools
import itertools
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def stencil_main(args):
    """The CMax stencil kernels against ``args.baseline``."""
    import numpy as np
    import torch

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
    return emit({"device": torch.cuda.get_device_name(0),
                 "card": cs.card_line(), "shape": [b, h, w], "radius": r,
                 "ptxas": ptxas, "agreement": agree, "times": times},
                args.out)


NO_ATOMIC = """
// written by tools/stencil_ab.py: every atomicAdd below is a store that
// never happens (no vote is this NaN), so the reads and the arithmetic stay
__device__ __forceinline__ void ebt_no_atomic(float* p, float v) {
  if (__float_as_uint(v) == 0x7fffffffu) *p = v;
}
#define atomicAdd(p, v) ebt_no_atomic((p), (v))
"""

#: the per-tile design's tile shape (rows, columns; powers of two) and the
#: most votes one of its accumulate blocks takes (a longer bin is split)
TILED_TILE = (32, 64)
TILED_CHUNK = 1024


def no_atomic_variant(source):
    """``source`` with its ``atomicAdd``s turned into stores that never
    happen, written under ``build/``; returns its path."""
    with open(source) as f:
        text = f.read()
    cut = text.index("\n", text.rindex("#include")) + 1
    path = os.path.join(REPO, "build", "ab_vote_no_atomics.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text[:cut] + NO_ATOMIC + text[cut:])
    return path


def ptxas_lines(built):
    return [line.strip() for line in str(built["log"]).splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line or "smem" in line]


def device_ms(fn, by_name=False):
    """Device time (ms) of one call of ``fn`` as the profiler sums it over
    the kernels, copies and fills it ran, and their number (or, with
    ``by_name``, ``{name: ms}``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if by_name:
        names = {}
        for e in ops:
            names[e.name[:60]] = (names.get(e.name[:60], 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
        return names
    return sum(e.time_range.elapsed_us() for e in ops) / 1e3, len(ops)


def tiled_library(source):
    """The per-tile vote design (``tools/hat_vote_tiled.cu``) built into a
    library of its own, its entry ``ebt_vote_tiled`` declared."""
    from event_based_bos_tpu_torch import kernels

    built = kernels.build([source])
    lib = kernels.load(built["path"])
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.ebt_vote_tiled.argtypes = [p, p, p, p, i, p, f, p, i, ll, f, f, i, i,
                                   i, i, i, i, i, i, i, p, p, p, p]
    lib.ebt_vote_tiled.restype = i
    return lib, built


def tiled_vote(lib, x, y, values, image_size, *, valid=None, sign=None,
               polarity_planes=None, scale=1.0, plane=None, planes=None,
               offset=(0.0, 0.0), origin=(0, 0), pitch=None, nudge=False,
               tile=TILED_TILE, chunk=TILED_CHUNK):
    """``iwe_cuda.hat_vote`` on the per-tile design: the same arguments
    and result, the scratch its three launches need allocated here.
    Counts no launch."""
    import torch

    from event_based_bos_tpu_torch.ops import iwe_cuda

    h, w, pitch, n_planes = iwe_cuda._arguments(
        x, y, values, image_size, valid, sign, polarity_planes, plane,
        planes, origin, pitch)
    xx, yy = (t.to(torch.float32).contiguous() for t in (x, y))
    ww = None if values is None else values.to(torch.float32).contiguous()
    vv = (None if valid is None
          else valid.to(torch.bool).contiguous().view(torch.uint8))
    pol = sign if sign is not None else polarity_planes
    if pol is not None:
        pol = (pol.contiguous() if pol.dtype == torch.float32
               else torch.sign(pol).to(torch.float32))
    p_mode = 1 if sign is not None else 2 if pol is not None else 0
    pl = None if plane is None else plane.to(torch.int32).contiguous()
    n = xx.shape[0]
    th, tw = tile
    n_bins = n_planes * -(-h // th) * -(-pitch // tw)
    dev = x.device
    out = torch.empty((n_planes, h, pitch), dtype=torch.float32, device=dev)
    meta = torch.empty((5 * n_bins + 3 + -(-4 * n // chunk),),
                       dtype=torch.int32, device=dev)
    entries = torch.empty((max(1, 4 * n), 2), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.ebt_vote_tiled(
        xx.data_ptr(), yy.data_ptr(), ptr(vv), ptr(pol), p_mode, ptr(ww),
        float(scale), ptr(pl), n_planes, n, float(offset[0]),
        float(offset[1]), int(origin[0]), int(origin[1]), int(nudge), h, w,
        pitch, th, tw, chunk, meta.data_ptr(), entries.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiled vote launch failed (error {err})")
    out = out[..., :w] if pitch != w else out
    return out[0] if planes is None and polarity_planes is None else out


def vote_main(args):
    """The event vote against ``args.baseline`` (the atomic design) and the
    per-tile design."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import (events_from_arrays,
                                           events_from_ndarray, kernels)
    from event_based_bos_tpu_torch.ops import iwe_cuda
    from event_based_bos_tpu_torch.solver.cmax import (_roi_box,
                                                       binned_histograms,
                                                       time_bin_index)

    baseline = args.baseline or os.path.join(REPO, "tools",
                                             "hat_vote_atomic.cu")
    ptxas, libs = {}, {}
    for name, source in (("current", None), ("baseline", baseline),
                         ("no_atomics", no_atomic_variant(baseline))):
        built = kernels.build(None if source is None else [source])
        ptxas[name] = ptxas_lines(built)
        if source is not None:
            libs[name] = cs.atomic_vote_library(source)
    tiled, built = tiled_library(args.tiled)
    ptxas["tiled"] = ptxas_lines(built)
    for name, lines in ptxas.items():
        for line in lines:
            print(f"{name} ptxas: {line}")
    kernels.library()
    base, noat = libs["baseline"], libs["no_atomics"]

    h, w = cs.H, cs.W
    dev = torch.device("cuda")
    events, _frame, _gt = cs.make_workload()
    ev = events_from_ndarray(events, capacity=cs.CAPACITY, device=dev)
    x = torch.where(ev.valid, ev.x, -2.0).contiguous()
    y = torch.where(ev.valid, ev.y, -2.0).contiguous()
    v = torch.where(ev.valid, torch.where(ev.p > 0, 1.0, -1.0),
                    0.0).contiguous()
    order = torch.argsort(torch.where(ev.valid, ev.x * w + ev.y, -1.0))
    xs, ys, vs = (a[order].contiguous() for a in (x, y, v))
    rng = np.random.default_rng(2)
    n = cs.CAPACITY
    skew = events_from_arrays(rng.integers(64, 96, n),
                              rng.integers(128, 160, n),
                              np.sort(rng.uniform(0, 1, n)),
                              rng.integers(0, 2, n) * 2 - 1, device=dev)
    kx, ky = skew.x.contiguous(), skew.y.contiguous()
    kv = torch.where(skew.p > 0, 1.0, -1.0).contiguous()
    spec = cs.cmax_cell_spec()
    box = _roi_box(spec)
    bshape = (box[1] - box[0], box[3] - box[2])

    def kernel_binned():
        return binned_histograms(ev, spec, crop=box, pitched=True)[0]

    def binned(vote):
        """The bin index and the 16-bin box vote, as binned_histograms
        makes them, on ``vote``."""
        return lambda: vote(ev.x, ev.y, None, bshape, valid=ev.valid,
                            plane=time_bin_index(ev, spec.time_bins),
                            planes=spec.time_bins, origin=box[::2],
                            pitch=-(-bshape[1] // 4) * 4, nudge=True)

    routes = {
        "bare": (lambda: cs.atomic_vote(base, x, y, v, (h, w)),
                 lambda: iwe_cuda.hat_vote_image(x, y, v, (h, w))),
        "bare, events sorted by pixel": (
            lambda: cs.atomic_vote(base, xs, ys, vs, (h, w)),
            lambda: iwe_cuda.hat_vote_image(xs, ys, vs, (h, w))),
        "bare, skewed input": (
            lambda: cs.atomic_vote(base, kx, ky, kv, (h, w)),
            lambda: iwe_cuda.hat_vote_image(kx, ky, kv, (h, w))),
        "signed cache vote": (
            lambda: cs.atomic_signed_vote(base, ev, (h, w)),
            lambda: iwe_cuda.signed_vote_cuda(ev, (h, w))),
        "16-bin histograms, box": (
            lambda: cs.scatter_box_histograms(ev, spec), kernel_binned),
    }
    zeroed = torch.zeros((h, w), dtype=torch.float32, device=dev)
    parts = {
        "zeros of the image": lambda: torch.zeros((h, w), device=dev),
        "kernel alone, image zeroed beforehand":
            lambda: cs.atomic_vote(base, x, y, v, (h, w), out=zeroed),
        "no atomics (zeros + kernel)":
            lambda: cs.atomic_vote(noat, x, y, v, (h, w)),
        "preparation from the event record": lambda: cs.atomic_prepared(ev),
    }
    agree = {}
    for key, (old, new) in routes.items():
        a, b = old(), new()
        torch.cuda.synchronize()
        agree[key] = {"bit_identical": bool(a.shape == b.shape
                                            and torch.equal(a, b)),
                      "max_abs_diff": float((a - b).abs().max())
                      if a.shape == b.shape else None}
        print(f"{key}: {agree[key]}")

    flush = cs.l2_flush(dev)
    times = {}
    for key, (old, new) in routes.items():
        runs = {"baseline": [], "current": []}
        for name in ("baseline", "current", "current", "baseline"):
            runs[name].append(cs.cuda_ms(old if name == "baseline" else new,
                                         flush=flush))
        times[key] = {k: {"ms": r, "median_ms": statistics.median(r)}
                      for k, r in runs.items()}
        print(f"{key}: " + ", ".join(
            f"{k} {r['median_ms']:.4f} ms ({r['ms'][0]:.4f}, {r['ms'][1]:.4f})"
            for k, r in times[key].items()))
    for key, fn in parts.items():
        runs = [cs.cuda_ms(fn, flush=flush) for _ in range(2)]
        times[key] = {"baseline": {"ms": runs,
                                   "median_ms": statistics.median(runs)}}
        print(f"{key}: {times[key]['baseline']['median_ms']:.4f} ms")
    histograms = {}
    for name, fn in (("baseline", routes["16-bin histograms, box"][0]),
                     ("current", kernel_binned)):
        dev_ms, n_ops = device_ms(fn)
        histograms[name] = {"span_ms": cs.span_ms(fn, flush),
                            "device_ms": dev_ms, "device_ops": n_ops}
        print(f"16-bin histograms, {name}: {histograms[name]}")

    def through(lib, fn):
        """``fn`` with the package's wrappers launching ``lib``'s entry."""
        def run():
            saved = kernels._lib  # the loaded library, swapped for the call
            kernels._lib = lib
            try:
                return fn()
            finally:
                kernels._lib = saved
        return run

    # the per-tile design and every --variant against the current kernel,
    # in turns, on the same calls
    tiled_hat_vote = functools.partial(tiled_vote, tiled)
    calls = {
        "bare": lambda vote: lambda: vote(x, y, v, (h, w)),
        "signed": lambda vote: lambda: vote(ev.x, ev.y, None, (h, w),
                                            valid=ev.valid, sign=ev.p),
        "skewed": lambda vote: lambda: vote(kx, ky, kv, (h, w)),
        "histograms": binned,
    }
    contenders = {"tiled": lambda make: make(tiled_hat_vote)}
    for source in args.variant or ():
        built = kernels.build([source])
        name = os.path.basename(source)
        ptxas[name] = ptxas_lines(built)
        contenders[name] = (lambda lib: lambda make: through(
            lib, make(iwe_cuda.hat_vote)))(kernels.load(built["path"]))
    versus = {}
    for name, contender in contenders.items():
        versus[name] = {}
        for key, make in calls.items():
            mine, other = make(iwe_cuda.hat_vote), contender(make)
            a, b = mine(), other()
            torch.cuda.synchronize()
            runs = {"current": [], name: []}
            for who in ("current", name, name, "current"):
                runs[who].append(cs.cuda_ms(mine if who == "current"
                                            else other, flush=flush))
            versus[name][key] = {
                "bit_identical": bool(torch.equal(a, b)),
                **{k: statistics.median(r) for k, r in runs.items()}}
            print(f"{name} vs current, {key}: {versus[name][key]}")
    # where each design's time goes
    breakdown = {f"{who} {key}": device_ms(make(vote), by_name=True)
                 for who, vote in (("current", iwe_cuda.hat_vote),
                                   ("tiled", tiled_hat_vote))
                 for key, make in calls.items()}
    for key, names in breakdown.items():
        print(f"{key} by kernel: " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in names.items()))
    sweep = []
    for tile, chunk in itertools.product(
            ((16, 32), (16, 64), (32, 32), (32, 64), (64, 64)),
            (1024, 2048, 4096, 8192) if args.sweep else ()):
        vote = functools.partial(tiled_vote, tiled, tile=tile, chunk=chunk)
        row = {"tile": tile, "chunk": chunk, **{
            k: cs.cuda_ms(make(vote), flush=flush)
            for k, make in calls.items()}}
        sweep.append(row)
        print(f"sweep of the tiled design {row}")
    n_box = spec.time_bins * bshape[0] * -(-bshape[1] // 4) * 4
    nbytes = {"bare": 12 * n + 4 * h * w, "signed": 13 * n + 4 * h * w,
              "histograms": 13 * n + 4 * n_box}
    return emit({"device": torch.cuda.get_device_name(0),
                 "card": cs.card_line(), "events": n, "image": [h, w],
                 "box": list(box), "bytes": nbytes,
                 "bound_ms": {k: b / cs.HBM_BYTES_PER_S * 1e3
                              for k, b in nbytes.items()},
                 "ptxas": ptxas, "agreement": agree, "times": times,
                 "histograms": histograms, "versus": versus,
                 "by_kernel": breakdown, "sweep": sweep}, args.out)


def emit(out, path):
    line = json.dumps(out)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("stencil", "vote"),
                    default="stencil")
    ap.add_argument("--baseline", default=None,
                    help="stencil: a cmax_stencil.cu with the same C entry "
                         "points, or with the earlier ones without the row "
                         "pitch (required); vote: a source with the entry "
                         "ebt_hat_vote (default tools/hat_vote_atomic.cu)")
    ap.add_argument("--tiled", default=os.path.join(REPO, "tools",
                                                    "hat_vote_tiled.cu"),
                    help="vote: the per-tile design (entry ebt_vote_tiled)")
    ap.add_argument("--variant", action="append",
                    help="vote: another source with the package's entry "
                         "ebt_vote, timed through the package's wrappers in "
                         "turns with the current one (repeatable)")
    ap.add_argument("--sweep", action="store_true",
                    help="vote: also time the per-tile design over tile "
                         "shapes and chunk lengths")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.kernel == "stencil" and not args.baseline:
        ap.error("--kernel stencil needs --baseline")
    if not torch.cuda.is_available():
        raise SystemExit("stencil_ab: needs a CUDA device")
    return (vote_main if args.kernel == "vote" else stencil_main)(args)


if __name__ == "__main__":
    sys.exit(main())
