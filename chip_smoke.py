#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``event_based_bos_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``; imports nothing of JAX.  Phases, each of which raises on
failure:

1. card identity (``nvidia-smi`` name and power limit) and TF32 switched off;
2. build of every CUDA kernel from ``event_based_bos_tpu_torch/csrc``
   (``hat_vote.cu`` and ``cmax_stencil.cu``) and of the vote kernel's
   earlier design (``tools/hat_vote_atomic.cu``), one ``nvcc`` each, in
   parallel;
3. the vote entry (``ops/iwe_cuda.py::hat_vote``) against its plain
   PyTorch version on the card at the main path's shapes (2^19 events,
   720×1280), bit-exact on integer coordinates: the signed, unsigned and
   masked cache votes, the polarity pair (one launch), the CMax cell's
   16-bin nudged vote into the 720×644 box (also against the per-bin
   scatter, cropped) and a skewed input (every event in one 32×32 window;
   also against the earlier kernel); ≤ 1e-5 on fractional / out-of-frame
   coordinates with padding (3, 5) and weights, and on their box vote.
   Times of the bare, signed, binned and skewed votes, the earlier kernel
   (its wrapper's preparation and zeroed image included) in turns with
   the current one, plain and ``index_add_`` times, against the HBM bound;
3b. the CMax stencil kernels (forward and backward) against their plain
   versions on the card at the CMax cell's shapes (16 bins of the
   workload's histograms over the 720×644 ROI box, R = 2) for a N(0, 0.8)
   flow, flow 0 (where both VJPs are exactly 0), an integer flow and a
   flow whose shifts reach 2R (beyond the stencil's reach), at 19×37 for
   R = 1, 3, 4, and at 19×37 on the kinks for R = 1–4 (dts ±0.5 and ±1,
   integer flows: every shift an integer or a half-integer): relative
   error < 1e-5; kernel, plain and library times (``grid_sample`` over the
   bins and a sum, forward and backward) against the bound (the bytes, or
   the operations of the taps these inputs need, whichever is larger).
   Every time in phases 3 and 3b is the median of 20 CUDA-event spans
   holding device time only, each after the L2 cache was flushed by
   reading 64 MB;
4. the main path at full width — the ``bench.py`` workload and spec: the
   IWE cache on the card, then ``estimate_frame`` (64→8 patches, 600
   iterations) — one warm-up frame, three timed frames and one frame that
   counts host synchronisations; the flow must be finite, exactly +0.0
   outside the ROI, voted by one kernel launch a frame, the same bit for
   bit in the three timed frames (same inputs and seed), within 0.30 px
   EPE of the synthetic ground truth, and at the EPE every run since the
   port began gave (0.1655 px);
4b. the CMax path at full width — the same workload under ``CmaxSpec``'s
   defaults with the bench ROI (dense flow, 64→16 patches, 260 Adam steps,
   16 bins, R = 2): ``estimate_frame_cmax``, one warm-up frame and three
   timed frames; the flow must be finite, the same bit for bit in the
   three timed frames, voted by one kernel launch a frame and launched
   through both stencil kernels exactly 260 times a frame, must not lower
   the IWE variance, and the loss must move
   at every scale; EPE against the ground truth is recorded, with no
   limit.  Then the same spec, driven the same way, on a full-width
   translating dot pattern on integer sensor coordinates (motion inside
   R = 2's envelope): besides the same checks, the IWE variance must grow
   and the flow's medians come within 0.5 px of the motion, at the medians
   every run since the CMax path was ported gave (2.358, −2.909 px);
5. a small float64 scene solved on the card and on the CPU, which must
   agree to 1e-6;
5b. a small float32 CMax scene (a translating dot pattern) solved through
   the kernels on the card and through their plain versions on the CPU,
   which must agree to 1e-3 px.

Prints a ``kernels`` JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no GPU or the port is missing.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

H, W = 720, 1280
ROI = (0, 720, 320, 960)
N_ITER = 600
CAPACITY = 1 << 19
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
F32_FLOPS = 67e12           # H100 SXM, f32 outside the tensor cores
EPE_LIMIT = 0.30
CMAX_RADIUS = 2
CMAX_REL_LIMIT = 1e-5      # bench.py's gate for the TPU kernel
CMAX_SMALL_LIMIT = 1e-3    # px, kernel route on the card vs plain on the CPU
DOT_MOTION = (2.0, -3.0)   # px/window: |dt·flow| <= 1.5 px, inside R = 2
# the seed-0 pyramid EPE and the dots' CMax flow medians as every run since
# the vote kernel and the stencil kernels were first checked gave them
PYRAMID_EPE = "0.1655"
DOT_MEDIANS = ("2.358", "-2.909")


def make_workload(seed=0):
    """``bench.py::make_workload``: the hot_plate1-scale synthetic window."""
    from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                          generate_sequence)

    cfg = SyntheticBosConfig(height=H, width=W, duration=1.0 / 30.0,
                             fps=30.0, events_per_frame=CAPACITY - 1024,
                             max_displacement=3.0, plume_speed=900.0,
                             seed=seed)
    seq = generate_sequence(cfg)
    events = seq["events"]
    events[:, 2] += 10.0
    return events, seq["frames"][1], seq["gt_flow"][0]


def accuracy_epe(flow, gt_flow):
    """``bench.py::accuracy_epe``: mean EPE over the ROI of −flow vs GT."""
    import numpy as np

    pred = -np.asarray(flow)[:, ROI[0]:ROI[1], ROI[2]:ROI[3]]
    gt = np.asarray(gt_flow)[:, ROI[0]:ROI[1], ROI[2]:ROI[3]]
    return float(np.mean(np.linalg.norm(pred - gt, axis=0)))


def cuda_ms(fn, reps=20, warmup=3, flush=None):
    """Median CUDA-event time of ``fn`` in ms; ``flush`` runs between reps
    (outside the timed span) to evict the inputs from L2.  Before each rep
    the stream spins for ~0.5 ms, so that the host has queued the start
    event, ``fn``'s launches and the end event before the device reaches
    them: the span holds device time, not the wrapper's host time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def l2_flush(device):
    """A callable that evicts the L2 cache (50 MB on an H100) by reading
    64 MB: a read leaves no dirty lines, whose write-backs a memset flush
    would add to the next kernel's time."""
    import torch

    buf = torch.zeros(64 << 20, dtype=torch.uint8, device=device)
    return buf.max


def atomic_vote_library(source=None):
    """The vote kernel's earlier design (``tools/hat_vote_atomic.cu``: one
    thread per event, one global ``atomicAdd`` per corner into an image
    zeroed beforehand) built from ``source`` (that file by default) into a
    library of its own, for timing in turns against the current kernel;
    its entry point is ``ebt_hat_vote(x, y, v, n, h, w, out, stream)``."""
    import ctypes

    from event_based_bos_tpu_torch import kernels

    if source is None:
        source = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tools", "hat_vote_atomic.cu")
    lib = kernels.load(kernels.build([source])["path"])
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ebt_hat_vote.argtypes = [p, p, p, ll, i, i, p, p]
    lib.ebt_hat_vote.restype = i
    return lib


def atomic_vote(lib, x, y, v, size, out=None):
    """``lib``'s vote of the prepared float32 ``x``, ``y``, ``v`` into a
    new zeroed ``[H, W]`` image (as its wrapper did), or added into
    ``out``.  Counts no launch."""
    import torch

    if out is None:
        out = torch.zeros(size, dtype=torch.float32, device=x.device)
    err = lib.ebt_hat_vote(x.data_ptr(), y.data_ptr(), v.data_ptr(),
                           x.numel(), size[0], size[1], out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"atomic vote launch failed (cudaError {err})")
    return out


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def atomic_prepared(ev):
    """``x``, ``y``, ``v`` of the signed cache vote as the atomic kernel's
    wrapper prepared them from the event record, op for op (about ten
    elementwise launches)."""
    import torch

    val = torch.where(ev.valid, torch.ones_like(ev.x), 0.0)
    val = val * torch.where(ev.p > 0, 1.0, -1.0)
    val = val * 1.0
    x = torch.where(ev.valid, ev.x, -2.0).to(torch.float32).contiguous()
    y = torch.where(ev.valid, ev.y, -2.0).to(torch.float32).contiguous()
    return x + 0, y + 0, val.to(torch.float32).contiguous()


def atomic_signed_vote(lib, ev, size):
    """The signed cache vote as it was made with the atomic kernel: the
    preparation, a zeroed image, the kernel."""
    return atomic_vote(lib, *atomic_prepared(ev), size)


def scatter_box_histograms(ev, spec):
    """The CMax histograms as the solve built them before the vote kernel
    served them: one torch scatter a bin, stacked, cropped to the widened
    ROI box."""
    import torch

    from event_based_bos_tpu_torch.ops import iwe
    from event_based_bos_tpu_torch.solver.cmax import _roi_box, time_bin_index

    bins = time_bin_index(ev, spec.time_bins)
    hists = torch.stack([iwe.bilinear_vote(ev.mask_where(bins == i),
                                           spec.image_size)
                         for i in range(spec.time_bins)])
    bx0, bx1, by0, by1 = _roi_box(spec)
    return hists[:, bx0:bx1, by0:by1]


def span_ms(fn, flush=None, reps=5):
    """Median CUDA-event span around ``fn`` as the host issues it (no spin
    before it, so a call of many launches shows its host time)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def vote_bound(nbytes, live_votes):
    """Least time (ms) of a vote on an H100 SXM and what bounds it: the
    bytes (each input read once, each output written once) against ~18 f32
    operations a live corner vote (floors, offsets, corner products, the
    add)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 18 * live_votes / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def corner_index_add(corners, planes, h, pitch):
    """The library yardstick of a vote: the flat indices and values of its
    live corner votes (built beforehand), and one ``index_add_`` of them
    into a zeroed ``[planes·h·pitch]`` buffer."""
    import torch

    idx = torch.cat([((q * h + r) * pitch + c)[k]
                     for q, r, c, _v, k in corners])
    val = torch.cat([v[k] for _q, _r, _c, v, k in corners])
    size = planes * h * pitch
    return lambda: torch.zeros(size, device=idx.device).index_add_(0, idx,
                                                                   val)


def check_vote_kernel(events, device, atomic_lib):
    """Phase 3: the vote kernel against its plain version, full size, and
    its times beside those of the atomic kernel (``atomic_lib``)."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import (events_from_arrays,
                                           events_from_ndarray, kernels)
    from event_based_bos_tpu_torch.ops import iwe, iwe_cuda
    from event_based_bos_tpu_torch.solver.cmax import (_roi_box,
                                                       binned_histograms,
                                                       time_bin_index)

    dev = torch.device(device)
    ev = events_from_ndarray(events, capacity=CAPACITY, device=dev)
    sign = torch.where(ev.p > 0, 1.0, -1.0)
    # the bare function's inputs, prepared as the earlier wrapper did
    x = torch.where(ev.valid, ev.x, -2.0).contiguous()
    y = torch.where(ev.valid, ev.y, -2.0).contiguous()
    v = torch.where(ev.valid, sign, 0.0).contiguous()
    plain = iwe_cuda.hat_vote_plain

    def exact(name, got, *refs):
        torch.cuda.synchronize()
        for ref_name, ref in refs:
            assert got.shape == ref.shape and torch.equal(got, ref), \
                f"vote {name} differs from {ref_name}"
        print(f"vote {name}: bit-exact vs "
              + ", ".join(ref_name for ref_name, _ in refs))

    # integer sensor coordinates: bit-exact
    exact("signed, integer coordinates",
          iwe_cuda.signed_vote_cuda(ev, (H, W)),
          ("plain", plain(ev.x, ev.y, None, (H, W), valid=ev.valid,
                          sign=ev.p)),
          ("the scatter", iwe.bilinear_vote(ev, (H, W), weight=sign)),
          ("the atomic kernel", atomic_vote(atomic_lib, x, y, v, (H, W))))
    exact("unsigned, integer coordinates",
          iwe_cuda.bilinear_vote_cuda(ev, (H, W)),
          ("plain", plain(ev.x, ev.y, None, (H, W), valid=ev.valid)),
          ("the scatter", iwe.bilinear_vote(ev, (H, W))))
    kernels.reset_launches()
    pol = iwe_cuda.polarity_iwe_cuda(ev, (H, W))
    assert kernels.launches["hat_vote_image"] == 1, kernels.launches
    exact("polarity pair in one launch", pol,
          ("plain", plain(ev.x, ev.y, None, (H, W), valid=ev.valid,
                          polarity_planes=ev.p)),
          ("the scatter", iwe.create_polarity_iwe(ev, (H, W))))
    rng = np.random.default_rng(1)
    keep = torch.as_tensor(rng.integers(0, 2, CAPACITY) > 0, device=dev)
    masked = ev.mask_where(keep)
    exact("signed, masked batch", iwe_cuda.signed_vote_cuda(masked, (H, W)),
          ("the scatter", iwe.bilinear_vote(masked, (H, W), weight=torch.where(
              masked.p > 0, 1.0, -1.0))))
    spec = cmax_cell_spec()
    box = _roi_box(spec)
    bx0, bx1, by0, by1 = box
    bins = time_bin_index(ev, spec.time_bins)
    bshape = (bx1 - bx0, by1 - by0)
    bpitch = -(-bshape[1] // 4) * 4
    bargs = dict(valid=ev.valid, plane=bins, planes=spec.time_bins,
                 origin=(bx0, by0), pitch=bpitch, nudge=True)
    got_b, _dts = binned_histograms(ev, spec, crop=box, pitched=True)
    exact(f"{spec.time_bins}-bin box {bshape[0]}x{bshape[1]}, nudged",
          got_b, ("plain", plain(ev.x, ev.y, None, bshape, **bargs)),
          ("the per-bin scatter, cropped", scatter_box_histograms(ev, spec)))
    # every event in one 32x32 window: 512 votes a pixel
    n = CAPACITY
    skew = events_from_arrays(rng.integers(64, 96, n),
                              rng.integers(128, 160, n),
                              np.sort(rng.uniform(0, 1, n)),
                              rng.integers(0, 2, n) * 2 - 1, device=dev)
    kx, ky = skew.x.contiguous(), skew.y.contiguous()
    kv = torch.where(skew.p > 0, 1.0, -1.0).contiguous()
    exact("skewed input (2^19 events in one 32x32 window)",
          iwe_cuda.hat_vote_image(kx, ky, kv, (H, W)),
          ("plain", plain(kx, ky, kv, (H, W))),
          ("the atomic kernel", atomic_vote(atomic_lib, kx, ky, kv, (H, W))))

    # fractional and out-of-frame coordinates, padding (3, 5), weights
    ph, pw = 3, 5
    fx = torch.as_tensor(rng.uniform(-6, H + 6, CAPACITY), dtype=torch.float32,
                         device=dev)
    fy = torch.as_tensor(rng.uniform(-8, W + 8, CAPACITY), dtype=torch.float32,
                         device=dev)
    wgt = torch.as_tensor(rng.uniform(0.2, 2.0, CAPACITY),
                          dtype=torch.float32, device=dev)
    frac = ev._replace(x=fx, y=fy).mask_where(keep)
    got_f = iwe_cuda.bilinear_vote_cuda(frac, (H, W), wgt, (ph, pw))
    plain_f = plain(fx, fy, wgt, (H + 2 * ph, W + 2 * pw), valid=frac.valid,
                    offset=(ph, pw))
    scatter_f = iwe.bilinear_vote(frac, (H, W), wgt, (ph, pw))
    got_fb, _ = binned_histograms(frac, spec, crop=box, pitched=True)
    plain_fb = plain(fx, fy, None, bshape, **dict(
        bargs, valid=frac.valid, plane=time_bin_index(frac, spec.time_bins)))
    err_plain = float((got_f - plain_f).abs().max())
    err_scatter = float((got_f - scatter_f).abs().max())
    err_box = float((got_fb - plain_fb).abs().max())
    assert got_f.shape == (H + 2 * ph, W + 2 * pw)
    assert err_plain <= 1e-5, f"fractional vote vs plain: {err_plain:.3e}"
    assert err_box <= 1e-5, f"fractional box vote vs plain: {err_box:.3e}"
    # The scatter floors the unshifted coordinate (with its 1e-6 nudge); the
    # kernel sees x + ph, whose f32 rounding at ~1280 px moves the hat
    # weights by up to ulp(1280)/2 = 6e-5 each.  A wrong corner would cost
    # O(1), so 1e-3 separates the two.
    assert err_scatter <= 1e-3, f"fractional vote vs scatter: {err_scatter:.3e}"
    print(f"vote fractional/out-of-frame, padding {(ph, pw)}, weights, "
          f"masked: max|diff| {err_plain:.3e} vs plain (limit 1e-5), "
          f"{err_scatter:.3e} vs the unshifted scatter (limit 1e-3); the "
          f"nudged box vote of these coordinates {err_box:.3e} vs plain "
          f"(limit 1e-5)")

    # times at the main path's shapes, integer coordinates; the atomic
    # kernel in turns with the current one
    flush = l2_flush(dev)

    def turns(new, old):
        runs = {"new": [], "old": []}
        for k in ("old", "new", "new", "old"):
            runs[k].append(cuda_ms(new if k == "new" else old, flush=flush))
        return statistics.median(runs["new"]), statistics.median(runs["old"])

    live = int((v != 0).sum())
    times = {}
    bare, bare_atomic = turns(
        lambda: iwe_cuda.hat_vote_image(x, y, v, (H, W)),
        lambda: atomic_vote(atomic_lib, x, y, v, (H, W)))
    times["bare"] = dict(
        ms=bare, atomic_ms=bare_atomic,
        plain_ms=cuda_ms(lambda: plain(x, y, v, (H, W)), flush=flush),
        library_ms=cuda_ms(corner_index_add(iwe_cuda.vote_corners(
            x, y, v, (H, W)), 1, H, W), flush=flush),
        nbytes=3 * 4 * n + 4 * H * W)
    signed, signed_atomic = turns(
        lambda: iwe_cuda.signed_vote_cuda(ev, (H, W)),
        lambda: atomic_signed_vote(atomic_lib, ev, (H, W)))
    times["signed"] = dict(
        ms=signed, atomic_ms=signed_atomic,
        plain_ms=cuda_ms(lambda: plain(ev.x, ev.y, None, (H, W),
                                       valid=ev.valid, sign=ev.p),
                         flush=flush),
        library_ms=times["bare"]["library_ms"], nbytes=13 * n + 4 * H * W)
    # the 16-bin box vote alone (bins made beforehand), and the whole
    # binned_histograms call (the bin index, ~8 torch launches, included)
    times["binned"] = dict(
        ms=cuda_ms(lambda: iwe_cuda.hat_vote(ev.x, ev.y, None, bshape,
                                             **bargs), flush=flush),
        call_ms=cuda_ms(lambda: binned_histograms(ev, spec, crop=box,
                                                  pitched=True), flush=flush),
        span_ms=span_ms(lambda: binned_histograms(ev, spec, crop=box,
                                                  pitched=True), flush),
        scatter_span_ms=span_ms(lambda: scatter_box_histograms(ev, spec),
                                flush),
        plain_ms=cuda_ms(lambda: plain(ev.x, ev.y, None, bshape, **bargs),
                         flush=flush),
        library_ms=cuda_ms(corner_index_add(iwe_cuda.vote_corners(
            ev.x, ev.y, None, bshape, **{k: a for k, a in bargs.items()
                                         if k != "pitch"}),
            spec.time_bins, bshape[0], bpitch), flush=flush),
        nbytes=13 * n + 4 * spec.time_bins * bshape[0] * bpitch)
    skewed, skewed_atomic = turns(
        lambda: iwe_cuda.hat_vote_image(kx, ky, kv, (H, W)),
        lambda: atomic_vote(atomic_lib, kx, ky, kv, (H, W)))
    times["skewed"] = dict(ms=skewed, atomic_ms=skewed_atomic,
                           nbytes=3 * 4 * n + 4 * H * W)
    for name, t in times.items():
        t["bound_ms"], t["bound_by"] = vote_bound(
            t["nbytes"], n if name == "skewed" else live)
        print(f"vote {name} times (median of 20, L2 flushed): kernel "
              f"{t['ms']:.4f} ms"
              + (f", atomic kernel {t['atomic_ms']:.4f} ms"
                 if "atomic_ms" in t else "")
              + (f", plain {t['plain_ms']:.4f} ms, index_add_ "
                 f"{t['library_ms']:.4f} ms" if "plain_ms" in t else "")
              + (f", the whole call {t['call_ms']:.4f} ms, its span as "
                 f"issued {t['span_ms']:.4f} ms (the per-bin scatter "
                 f"{t['scatter_span_ms']:.3f} ms)" if "span_ms" in t else "")
              + f", bound {t['bound_ms'] * 1e3:.2f} us ({t['nbytes']} B, "
              f"{t['bound_by']})")
    kernels.reset_launches()
    bare_t = times.pop("bare")
    return {"name": "hat_vote_image", "route": "cuda",
            "source": "event_based_bos_tpu_torch/csrc/hat_vote.cu",
            "replaces": "event_based_bos_tpu/ops/iwe_pallas.py:153",
            "max_abs_err": max(err_plain, err_box), "ms": bare_t["ms"],
            "plain_ms": bare_t["plain_ms"], "bound_ms": bare_t["bound_ms"],
            "bound_by": bare_t["bound_by"],
            "library_ms": bare_t["library_ms"],
            "atomic_ms": bare_t["atomic_ms"], **times}


def cmax_cell_spec():
    """The CMax cell: ``CmaxSpec``'s defaults with the bench ROI."""
    from event_based_bos_tpu_torch.solver.cmax import CmaxSpec

    return CmaxSpec(image_size=(H, W), roi=ROI)


def box_histograms(ev, spec):
    """The per-bin histograms over the widened ROI box in the stencil
    kernels' layout, as the solve makes them, and the bin dts."""
    from event_based_bos_tpu_torch.solver.cmax import (_roi_box,
                                                       binned_histograms)

    return binned_histograms(ev, spec, crop=_roi_box(spec), pitched=True)


def iwe_variances(ev, flow, spec):
    """The binned objective's IWE variance at flow 0 and at ``flow``."""
    import torch

    from event_based_bos_tpu_torch import costs
    from event_based_bos_tpu_torch.solver.cmax import _roi_box, binned_iwe

    hists, dts = box_histograms(ev, spec)
    bx0, bx1, by0, by1 = _roi_box(spec)
    flow_box = flow[:, bx0:bx1, by0:by1]
    with torch.no_grad():
        return tuple(float(costs.image_variance({"iwe": binned_iwe(
            hists, dts, f, spec)})) for f in (torch.zeros_like(flow_box),
                                              flow_box))


def cmax_bound(hists, flow, dts, radius, backward):
    """Least time (ms) of the stencil on an H100 SXM for these inputs, and
    what bounds it: HBM bytes with each input read once and each output
    written once, against the f32 operations these inputs need.

    hat(a + o) and dhat(a + o) are nonzero only where |a + o| < 1, so a
    pixel and bin need n_u·n_v taps (n ≤ 2 offsets per axis; 1 on an
    integer shift), not all (2R+1)².  Per pixel and bin the forward needs
    2 + 4(n_u + n_v) + 3·n_u·n_v operations (the two shifts; add, abs, sub,
    max per hat weight; a weight product and an FMA, counted as two, per
    tap) and the backward 2 + 7(n_u + n_v) + 9·n_u·n_v (dhat adds a
    compare, a sign and a select per offset; a tap is g·h, then four
    operations each for du and dv)."""
    import torch

    b, h, w = hists.shape
    px = h * w
    shifts = -dts[:, None, None, None] * flow[None]            # [B, 2, h, w]
    n = sum((shifts + o).abs() < 1
            for o in range(-radius, radius + 1)).to(torch.int64)
    n_axes = int(n.sum())
    n_taps = int((n[:, 0] * n[:, 1]).sum())
    if backward:
        ops = 2 * b * px + 7 * n_axes + 9 * n_taps
        nbytes = 4 * (b * px + 2 * px + px + b + 2 * px)
    else:
        ops = 2 * b * px + 4 * n_axes + 3 * n_taps
        nbytes = 4 * (b * px + 2 * px + b + px)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def grid_sample_yardstick(hists, flow, dts, g):
    """The library yardstick of the stencil: ``grid_sample`` of the B
    histograms as a (B, 1, h, w) batch at x + dt_b·flow (bilinear, zeros
    outside, ``align_corners=True``), then ``.sum(0)`` — 2 calls; and the
    backward of the two with respect to the grid for the cotangent ``g``.
    It is the stencil only where |dt·flow| ≤ R and off the kinks, so only
    its time is used; the port never calls it.  Returns ``(forward,
    backward)`` callables, the grid built beforehand."""
    import torch
    import torch.nn.functional as F

    b, h, w = hists.shape
    dev = hists.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    d = dts[:, None, None]
    grid = torch.stack([2 * (cols + d * flow[1]) / (w - 1) - 1,
                        2 * (rows + d * flow[0]) / (h - 1) - 1], -1)
    grid = grid.contiguous().requires_grad_(True)
    batch = hists[:, None]

    def forward():
        return F.grid_sample(batch, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True).sum(0)

    out = forward()
    cot = g[None]

    def backward():
        return torch.autograd.grad(out, grid, cot, retain_graph=True)[0]

    return forward, backward


def check_cmax_kernels(events, device):
    """Phase 3b: the CMax stencil kernels against their plain versions."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import events_from_ndarray, kernels
    from event_based_bos_tpu_torch.ops import cmax_cuda

    dev = torch.device(device)
    ev = events_from_ndarray(events, capacity=CAPACITY, device=dev)
    hists, dts = box_histograms(ev, cmax_cell_spec())
    b, h, w = hists.shape
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.uniform(0, 1, (h, w)), dtype=torch.float32,
                        device=dev)

    def rel(a, ref):
        return float((a - ref).abs().max() / (ref.abs().max() + 1e-12))

    def compare(hh, fl, dd, gg, radius):
        """Kernel (through the autograd wrapper) vs plain: rel. errors and
        max abs errors of the forward and the VJP."""
        fl = fl.clone().requires_grad_(True)
        out = cmax_cuda.binned_warp_accumulate(hh, fl, dd, radius)
        (dflow,) = torch.autograd.grad(out, fl, gg)
        p_out = cmax_cuda.binned_warp_accumulate_plain_fwd(hh, fl.detach(),
                                                           dd, radius)
        p_dflow = torch.stack(cmax_cuda.binned_warp_accumulate_plain_bwd(
            hh, fl.detach(), dd, gg, radius))
        torch.cuda.synchronize()
        out = out.detach()
        return (rel(out, p_out), rel(dflow, p_dflow),
                float((out - p_out).abs().max()),
                float((dflow - p_dflow).abs().max()), dflow, p_dflow)

    reach = 2 * CMAX_RADIUS / float(dts.abs().max())
    flows = {
        "N(0,0.8)": rng.normal(0, 0.8, (2, h, w)),
        "zero": np.zeros((2, h, w)),
        "integer": rng.integers(-3, 4, (2, h, w)),
        f"shifts to 2R (U(-{reach:.3g}, {reach:.3g}))":
            rng.uniform(-reach, reach, (2, h, w)),
    }
    err_fwd = err_bwd = 0.0
    for name, fl in flows.items():
        fl = torch.as_tensor(fl, dtype=torch.float32, device=dev)
        rf, rb, af, ab, dflow, p_dflow = compare(hists, fl, dts, g,
                                                 CMAX_RADIUS)
        err_fwd, err_bwd = max(err_fwd, af), max(err_bwd, ab)
        print(f"cmax stencil {b}x{h}x{w} R={CMAX_RADIUS}, flow {name}: "
              f"forward rel {rf:.3e}, VJP rel {rb:.3e} (limit "
              f"{CMAX_REL_LIMIT:g}); max|VJP| {float(dflow.abs().max()):.4g}")
        assert rf < CMAX_REL_LIMIT and rb < CMAX_REL_LIMIT, (name, rf, rb)
        if name == "zero":
            assert not dflow.any() and not p_dflow.any(), \
                "the VJP at flow 0 is not exactly 0"
    for radius in (1, 3, 4):
        hs, ws = 19, 37
        hh = torch.as_tensor(rng.uniform(0, 3, (3, hs, ws)),
                             dtype=torch.float32, device=dev)
        fl = torch.as_tensor(rng.uniform(-2 * radius, 2 * radius,
                                         (2, hs, ws)),
                             dtype=torch.float32, device=dev)
        dd = torch.tensor([-1 / 3, 0.0, 1 / 3], device=dev)
        gg = torch.as_tensor(rng.uniform(-1, 1, (hs, ws)),
                             dtype=torch.float32, device=dev)
        rf, rb = compare(hh, fl, dd, gg, radius)[:2]
        print(f"cmax stencil 3x{hs}x{ws} R={radius}: forward rel {rf:.3e}, "
              f"VJP rel {rb:.3e}")
        assert rf < CMAX_REL_LIMIT and rb < CMAX_REL_LIMIT, (radius, rf, rb)
    # on the kinks: every shift dt·flow an integer or a half-integer, to 2R
    for radius in (1, 2, 3, 4):
        hs, ws = 19, 37
        hh = torch.as_tensor(rng.uniform(0, 3, (4, hs, ws)),
                             dtype=torch.float32, device=dev)
        fl = torch.as_tensor(rng.integers(-2 * radius, 2 * radius + 1,
                                          (2, hs, ws)),
                             dtype=torch.float32, device=dev)
        dd = torch.tensor([-1.0, -0.5, 0.5, 1.0], device=dev)
        gg = torch.as_tensor(rng.uniform(-1, 1, (hs, ws)),
                             dtype=torch.float32, device=dev)
        rf, rb = compare(hh, fl, dd, gg, radius)[:2]
        print(f"cmax stencil 4x{hs}x{ws} R={radius} on the kinks: forward "
              f"rel {rf:.3e}, VJP rel {rb:.3e}")
        assert rf < CMAX_REL_LIMIT and rb < CMAX_REL_LIMIT, (radius, rf, rb)

    # times at the cell's shapes, the N(0, 0.8) flow
    fl = torch.as_tensor(flows["N(0,0.8)"], dtype=torch.float32, device=dev)
    flush = l2_flush(dev)
    r = CMAX_RADIUS
    timed = (
        ("cmax_stencil_fwd", 131, False,
         lambda: cmax_cuda.cmax_stencil_fwd(hists, fl, dts, r),
         lambda: cmax_cuda.binned_warp_accumulate_plain_fwd(hists, fl, dts,
                                                            r)),
        ("cmax_stencil_bwd", 156, True,
         lambda: cmax_cuda.cmax_stencil_bwd(hists, fl, dts, g, r),
         lambda: cmax_cuda.binned_warp_accumulate_plain_bwd(hists, fl, dts,
                                                            g, r)),
    )
    library = grid_sample_yardstick(hists, fl, dts, g)
    with torch.no_grad():
        lib_rel = rel(library[0]()[0], cmax_cuda.cmax_stencil_fwd(hists, fl,
                                                                  dts, r))
    print(f"grid_sample + sum vs the forward kernel, flow N(0,0.8): rel "
          f"{lib_rel:.3e} (the same function inside R, up to grid_sample's "
          f"coordinate rounding; printed, not held)")
    entries = []
    for name, line, backward, kernel, plain in timed:
        kernel_ms = cuda_ms(kernel, flush=flush)
        plain_ms = cuda_ms(plain, flush=flush)
        library_ms = cuda_ms(library[backward], flush=flush)
        bound_ms, bound_by, nbytes, ops = cmax_bound(hists, fl, dts, r,
                                                     backward)
        print(f"{name} times (median of 20, L2 flushed): kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample + "
              f"sum (2 calls) {library_ms:.4f} ms, bound "
              f"{bound_ms * 1e3:.2f} us ({nbytes} B, {ops} f32 ops, "
              f"{bound_by})")
        entries.append({
            "name": name, "route": "cuda",
            "source": "event_based_bos_tpu_torch/csrc/cmax_stencil.cu",
            "replaces": f"event_based_bos_tpu/ops/cmax_pallas.py:{line}",
            "max_abs_err": err_bwd if backward else err_fwd,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
    kernels.reset_launches()
    return entries


def run_main_path(events, frame, gt_flow, device):
    """Phase 4: the full-width per-frame solve, as ``bench.py`` runs it."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import events_from_ndarray, kernels
    from event_based_bos_tpu_torch.solver import GenerativeSpec, PyramidSpec
    from event_based_bos_tpu_torch.solver.generative import iwe_cache
    from event_based_bos_tpu_torch.solver.pyramid import (estimate_frame,
                                                          roi_mask)

    dev = torch.device(device)
    gen = GenerativeSpec(image_size=(H, W), iwe_sigma=2.0,
                         weight_by_inverse_event_hist=True,
                         optimize_warp=True, poisson_model=True)
    spec = PyramidSpec(gen=gen, roi=ROI, coarsest_patch=64, finest_patch=8,
                       n_iter=N_ITER)
    ev = events_from_ndarray(events, capacity=CAPACITY, device=dev)
    frame_t = torch.as_tensor(frame, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(roi_mask(spec), device=dev)

    def one_frame():
        cache = iwe_cache(ev, gen)
        return estimate_frame(None, frame_t, mask,
                              torch.Generator(dev).manual_seed(0), spec,
                              cache=cache, device=dev)

    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one_frame()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frame_ms, cache_ms, flows = [], [], []
    for _ in range(3):
        s, m, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        cache = iwe_cache(ev, gen)
        m.record()
        flow, aux = estimate_frame(None, frame_t, mask,
                                   torch.Generator(dev).manual_seed(0), spec,
                                   cache=cache, device=dev)
        e.record()
        e.synchronize()
        frame_ms.append(s.elapsed_time(e))
        cache_ms.append(s.elapsed_time(m))
        flows.append(flow)
    # the same inputs and seed: the solve should repeat bit for bit
    repeatable = all(torch.equal(f, flows[0]) for f in flows[1:])
    # one more frame with the host-sync detector on (after the timing)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        one_frame()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    flow_np = flow.cpu().numpy()
    outside = np.ones((H, W), bool)
    outside[ROI[0]:ROI[1], ROI[2]:ROI[3]] = False
    epe = accuracy_epe(flow_np, gt_flow)
    zero_epe = accuracy_epe(np.zeros_like(flow_np), gt_flow)
    losses = [float(h[-1]) for h in aux["loss_history"]]
    print(f"main path: per-frame {statistics.median(frame_ms):.1f} ms "
          f"(frames {', '.join(f'{t:.1f}' for t in frame_ms)}; IWE cache "
          f"{statistics.median(cache_ms):.3f} ms; warm-up {warm_s:.1f} s), "
          f"EPE {epe:.4f} px ({epe!r}; zero-flow {zero_epe:.4f} px), "
          f"vote launches {launches['hat_vote_image']} over 5 frames, "
          f"host syncs in one frame {syncs}, timed frames bit-identical "
          f"{repeatable}, peak memory {peak_gib:.2f} GiB, "
          f"final loss per scale {[round(v, 5) for v in losses]}")
    assert flow_np.shape == (2, H, W) and np.isfinite(flow_np).all()
    assert (flow_np[:, outside] == 0).all()
    assert not np.signbit(flow_np[:, outside]).any(), "−0.0 outside the ROI"
    assert launches["hat_vote_image"] == 5, \
        f"{launches['hat_vote_image']} vote launches in 5 frames, expected 5"
    assert f"{epe:.4f}" == PYRAMID_EPE, f"EPE {epe!r} moved from {PYRAMID_EPE}"
    assert repeatable, "the same frame and seed gave different flows"
    assert epe < EPE_LIMIT, f"EPE {epe:.4f} px ≥ {EPE_LIMIT}"
    return launches


def cmax_epe(flow, gt_flow):
    """Mean EPE over the ROI of the CMax flow as it is (the CMax facade
    returns the flow without a sign flip) vs GT."""
    import numpy as np

    return accuracy_epe(-np.asarray(flow), gt_flow)


def drive_cmax(scene, events, gt_flow, device):
    """The full-width CMax solve (``estimate_frame_cmax``) under the cell's
    spec: one warm-up frame and three timed frames, with the launch counts
    set to 0 just before and read just after.  Checks that the flow is
    finite, that each stencil kernel ran once per Adam step and that the
    three timed flows are the same bit for bit; returns the launches, the
    flow, the IWE variance at flow 0 and at the solution, and the loss
    history of each scale."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import events_from_ndarray, kernels
    from event_based_bos_tpu_torch.solver.cmax import (_roi_box,
                                                       binned_histograms,
                                                       estimate_frame_cmax,
                                                       scale_iterations)

    dev = torch.device(device)
    spec = cmax_cell_spec()
    steps = sum(scale_iterations(spec))
    ev = events_from_ndarray(events, capacity=CAPACITY, device=dev)

    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    estimate_frame_cmax(ev, None, None, spec, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frame_ms, flows = [], []
    for _ in range(3):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        flow, aux = estimate_frame_cmax(ev, None, None, spec, device=dev)
        e.record()
        e.synchronize()
        frame_ms.append(s.elapsed_time(e))
        flows.append(flow)
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    repeatable = all(torch.equal(f, flows[0]) for f in flows[1:])

    # the histograms alone as the solve makes them, and the contrast at
    # flow 0 and at the solution
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    hists, _dts = binned_histograms(ev, spec, crop=_roi_box(spec),
                                    pitched=True)
    e.record()
    e.synchronize()
    hist_ms = s.elapsed_time(e)
    var0, var1 = iwe_variances(ev, flow, spec)

    flow_np = flow.cpu().numpy()
    epe = cmax_epe(flow_np, gt_flow)
    zero_epe = cmax_epe(np.zeros_like(flow_np), gt_flow)
    per_frame = {k: launches[k] / 4 for k in launches}
    hist = [h.cpu().numpy() for h in aux["loss_history"]]
    ms = statistics.median(frame_ms)
    bx0, bx1, by0, by1 = _roi_box(spec)
    print(f"cmax path, {scene}: box {bx1 - bx0}x{by1 - by0}, "
          f"{hists.shape[0]} bins, R={spec.warp_radius}, {steps} Adam "
          f"steps; per-frame {ms:.1f} ms (frames "
          f"{', '.join(f'{t:.1f}' for t in frame_ms)}; warm-up "
          f"{warm_s:.1f} s), {ms / steps:.3f} ms per Adam step, histograms "
          f"{hist_ms:.3f} ms; launches per frame {per_frame}; EPE "
          f"{epe:.4f} px (zero-flow {zero_epe:.4f} px); max|flow| "
          f"{float(np.abs(flow_np).max()):.4g} px; IWE variance at flow 0 "
          f"{var0:.6g}, at the solution {var1:.6g}; timed frames "
          f"bit-identical {repeatable}; peak memory {peak_gib:.2f} GiB")
    print(f"cmax loss per scale, {scene} (first, best, best step of "
          + ", ".join(str(len(h)) for h in hist) + "): "
          + "; ".join(f"{h[0]:.6g}, {h.min():.6g}, {int(h.argmin())}"
                      for h in hist))
    assert flow_np.shape == (2, H, W) and np.isfinite(flow_np).all()
    for k, n in per_frame.items():
        want = 1 if k == "hat_vote_image" else steps
        assert n == want, f"{k}: {n} launches a frame, expected {want}"
    assert repeatable, f"the same frame gave different CMax flows ({scene})"
    return launches, flow_np, var0, var1, hist


def run_cmax_path(events, gt_flow, device):
    """Phase 4b, the cell: the bench scene.  No step of its solve beats the
    contrast at flow 0, so the best iterate is the start; the variance must
    not fall, and the loss must have moved at every scale (the iterates
    left flow 0)."""
    launches, _flow, var0, var1, hist = drive_cmax("bench scene", events,
                                                   gt_flow, device)
    # the start is the best iterate when no step beats the loss at flow 0
    assert var1 >= var0, f"the solve lowered the IWE variance {var0} -> {var1}"
    assert all((h != h[0]).any() for h in hist), "an iterate never moved"
    return launches


def check_cmax_sharpens(device):
    """Phase 4b, second scene: the cell's spec at full width on a
    translating dot pattern (523,264 events on integer sensor coordinates,
    as a camera gives them, so that the histograms and the solve repeat bit
    for bit; motion inside R = 2's envelope), where the contrast has a
    maximum away from flow 0.  Driven like the cell; the IWE variance must
    grow and the flow must find the motion, which needs the backward
    kernel's gradient."""
    import numpy as np

    vx, vy = DOT_MOTION
    evn = moving_dot_events(H, W, vx, vy, CAPACITY - 1024, seed=1)
    evn[:, :2] = np.round(evn[:, :2])
    gt = np.broadcast_to(np.array([vx, vy])[:, None, None], (2, H, W))
    _launches, flow_np, var0, var1, _hist = drive_cmax(
        f"translating dots ({vx:g}, {vy:g}) px/window", evn, gt, device)
    f = flow_np[:, ROI[0]:ROI[1], ROI[2]:ROI[3]]
    med = [float(np.median(f[i])) for i in (0, 1)]
    print(f"cmax translating dots: flow medians {med[0]:.3f}, {med[1]:.3f} "
          f"({med[0]!r}, {med[1]!r}; motion {vx:g}, {vy:g}; limit 0.5 px)")
    assert var1 > var0, f"the IWE variance did not grow: {var0} -> {var1}"
    assert abs(med[0] - vx) < 0.5 and abs(med[1] - vy) < 0.5, med
    assert tuple(f"{m:.3f}" for m in med) == DOT_MEDIANS, \
        f"the dots' medians {med} moved from {DOT_MEDIANS}"


def check_small_reference(device):
    """Phase 5: a small float64 solve on the card (kernel vote) and on the
    CPU (plain vote) must agree."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import events_from_ndarray
    from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                          generate_sequence)
    from event_based_bos_tpu_torch.solver import GenerativeSpec, PyramidSpec
    from event_based_bos_tpu_torch.solver.pyramid import (estimate_frame,
                                                          roi_mask)

    seq = generate_sequence(SyntheticBosConfig(
        height=64, width=96, duration=1.0 / 30.0, fps=30.0,
        events_per_frame=2000, max_displacement=3.0, plume_speed=300.0))
    gen = GenerativeSpec(image_size=(64, 96), dtype=torch.float64)
    spec = PyramidSpec(gen=gen, roi=(0, 64, 16, 80), coarsest_patch=16,
                       finest_patch=8, n_iter=24)
    init = np.zeros((3, 4, 6))
    init[0] = np.random.default_rng(0).uniform(-1, 1, (4, 6))
    flows = []
    for dev in (device, "cpu"):
        ev = events_from_ndarray(seq["events"], capacity=4096, device=dev)
        flow, _ = estimate_frame(ev, seq["frames"][1], roi_mask(spec), None,
                                 spec, init_params=init, device=dev)
        flows.append(flow.cpu())
    err = float((flows[0] - flows[1]).abs().max())
    print(f"small float64 scene, card vs CPU: max|flow diff| {err:.3e} "
          f"(limit 1e-6)")
    assert err <= 1e-6


def moving_dot_events(h, w, vx, vy, n, seed=0):
    """A rigidly translating dot pattern over one window (``(n, 4)``
    events; the CMax flow that sharpens it is ``(vx, vy)``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, n))
    x0 = rng.choice(np.arange(6, h - 14, 4), n).astype(float)
    y0 = rng.choice(np.arange(6, w - 14, 5), n).astype(float)
    x = x0 + vx * t + rng.normal(0, 0.1, n)
    y = y0 + vy * t + rng.normal(0, 0.1, n)
    return np.stack([x, y, t, np.ones(n)], 1)


def check_small_cmax(device):
    """Phase 5b: a small float32 CMax solve through the kernels on the card
    and through their plain versions on the CPU."""
    import torch

    from event_based_bos_tpu_torch import events_from_ndarray
    from event_based_bos_tpu_torch.solver.cmax import (CmaxSpec,
                                                       estimate_frame_cmax)

    hs, ws = 48, 64
    evn = moving_dot_events(hs, ws, 3.0, -4.0, 10000, seed=4)
    spec = CmaxSpec(image_size=(hs, ws), coarsest_patch=32, finest_patch=16,
                    n_iter=60, lr=0.5, smoothness=0.02, time_bins=4,
                    warp_radius=2)
    flows = []
    for dev in (device, "cpu"):
        ev = events_from_ndarray(evn, device=dev)
        flow, _ = estimate_frame_cmax(ev, None, None, spec, device=dev)
        flows.append(flow.cpu())
    err = float((flows[0] - flows[1]).abs().max())
    med = [float(flows[0][i].median()) for i in (0, 1)]
    # float32: the kernel contracts to FMAs and sums in another order than
    # the plain version, and 50 Adam steps amplify that; the port's CPU
    # route is held to JAX's Pallas route within 5e-4 px on this solve
    print(f"small float32 CMax scene ({hs}x{ws}, 50 Adam steps), card "
          f"kernels vs CPU plain: max|flow diff| {err:.3e} px (limit "
          f"{CMAX_SMALL_LIMIT:g}); flow medians {med[0]:.3f}, {med[1]:.3f} "
          f"(true motion 3, -4)")
    assert torch.isfinite(flows[0]).all()
    assert err <= CMAX_SMALL_LIMIT


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from event_based_bos_tpu_torch import kernels

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    # the port's kernels and the atomic vote kernel, built side by side
    with ThreadPoolExecutor(2) as pool:
        building = pool.submit(kernels.build)
        atomic = pool.submit(atomic_vote_library)
        built, atomic_lib = building.result(), atomic.result()
    kernels.library()
    print(f"build: {built['seconds']:.1f} s -> {built['path']}")
    for line in str(built["log"]).splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
            print(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    events, frame, gt_flow = make_workload()
    print(f"workload: {len(events)} events, {H}x{W} "
          f"({time.perf_counter() - t0:.1f} s to generate)")

    entries = [check_vote_kernel(events, "cuda", atomic_lib)]
    entries += check_cmax_kernels(events, "cuda")
    launches = run_main_path(events, frame, gt_flow, "cuda")
    entries[0]["launches"] = launches["hat_vote_image"]
    cmax_launches = run_cmax_path(events, gt_flow, "cuda")
    entries[0]["launches_cmax"] = cmax_launches["hat_vote_image"]
    for entry in entries[1:]:
        entry["launches"] = cmax_launches[entry["name"]]
    check_cmax_sharpens("cuda")
    check_small_reference("cuda")
    check_small_cmax("cuda")

    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
