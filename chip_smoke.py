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
   which must agree to 1e-3 px;
6. the serving loop at full width, as ``cli.main … --eval`` runs it, from
   a config dict (``configs/hot_plate1.yaml``'s solver, ROI and Farnebäck
   values on the SYNTHETIC loader at 720×1280 with 523,264 events a
   frame; ``visualize: false``, ``flow_convention: physical``, ``profile:
   true``): ``cli.evaluate_per_frames`` over three pyramid frames with the
   loader's true flow as GT.  Three finite ``pred_flow{i}.npy`` with −0.0
   outside the ROI, both error texts with three parsable lines and finite
   EPE, exactly one vote launch a frame for the IWE cache and one for the
   event mask, the first frame's flow bit-identical to ``estimate_frame``
   called directly on the same filtered events, frame and generator
   state, and the event-mask vote bit-identical to its plain version at
   the loop's arguments.  Then two frames of ``contrast_maximization``
   under ``CmaxSpec``'s defaults (one vote and 260 launches of each
   stencil kernel a frame, one vote for the event mask), and, where
   ``cv2`` is installed, one pyramid frame with the default Farnebäck GT.
   Prints ms/frame (host wall clock) and the ``profile`` section shares of
   each path;
7. the visualizing loop at full width (``visualize: true``, the default of
   every shipped config): phase 6's config and frames with a
   ``Visualizer(async_writes=True, device="cuda")``, then the post-loop
   flush and video assembly (``cli.write_videos``).  Every per-frame PNG
   decodes at 720×1280, the mp4s exist (with their frame counts) exactly
   where cv2 has a codec, the loss plots exactly where matplotlib is
   installed (else its one warning), the three ``pred_flow{i}.npy`` equal
   phase 6's bit for bit, the bundle's clipped IWE and event mask equal
   the plain vote bit for bit, and the vote launches a frame are exactly
   the IWE cache's, the bundle's clipped IWE's and the bundle's mask's
   (one each).  Prints ms/frame, the steady frame's ``finalize/visualize``
   and ``finalize/solve_wait`` shares, and the device time of the render
   bundle and of one Poisson view.  Then one CMax frame (3 votes, 260
   launches of each stencil kernel), ``run_mode: accumulate`` and the
   sequential mode over two 10 ms windows (2 and 1 votes a window), and
   one frame with the two-step Farnebäck GT (its Poisson views on the
   card);
8. golden parity at full width: the port's ``estimate_frame`` in float64
   at 40 iterations from the pinned init on the scene of
   ``tests/goldens/pyramid_720x1280_ref_flow.npy`` (the original
   reference's flow), over the ROI: MSE < 2e-2 and correlation > 0.95,
   printed beside the JAX package's measured 9.9e-3 / 0.972;
9. the pyramid's modes at full width on phase 4's workload, spec and
   seed: the first loss of each mode's objective within 1e-2 of the
   full-frame float32 one's from the same init; ``restrict_to_roi``
   (outside-norm stride 4) — a warm-up and three timed frames,
   bit-identical, EPE < 0.30 px, one vote launch a frame, ms/frame printed
   beside phase 4's —; one frame each of ``restrict_to_roi`` with
   ``compute_dtype: bfloat16`` and of ``warp_compute_bf16`` alone (EPE <
   0.30 px); each flow's correlation with the float32 flow printed, with
   no limit (the 770-step solve decorrelates under any perturbation, the
   JAX package's as well); small float64 restricted scenes on the card
   and on the CPU within 1e-6, at a full-height and a four-sided ROI;
   ``n_restarts = 3`` at 60 iterations, whose flow must equal bit for bit
   the best of three single solves from the same generator draws, with
   one vote launch;
10. the CCS loop: the port's synthetic scene at 720×1280 (523,264 events
   a frame) written under ``build/chip_smoke_ccs/`` in the CCS layout of
   ``configs/hot_plate1.yaml``'s sequence (raw EVT3 always, HDF5 too where
   ``h5py`` imports; ``frames.mp4`` through cv2's ``mp4v``; a
   non-identity homography), then ``cli.main([..., "--eval"])`` on a copy
   of ``configs/hot_plate1.yaml`` with only ``data.root``, ``output_dir``
   and ``time_list`` changed, two frames each: on EVT3, on HDF5, and on
   EVT3 with ``filters: [BAF, HOT]``.  The native runtime must have built
   (``g++``); finite error texts, +0.0 outside the ROI, three vote
   launches a frame (the visualizing loop), and the EVT3 flows equal to
   the HDF5 flows bit for bit where both ran;
11. the other solvers at full width on a uniform-displacement scene
   (``tests/reference_harness.py::synthetic_scene`` rebuilt here: 720×1280,
   du = (1.5, −0.8), 523,264 events on integer sensor coordinates): GML
   (the plain model with the warp pair, lr 0.05) with Adam, 600 steps, a
   warm-up and two timed frames (bit-identical, cosine of the fitted
   velocity with −du > 0.9); one frame each of BFGS (40), Nelder-Mead
   (200), Newton-CG (20), all from (0.1, −0.1, 0, 0), and of ``random``
   and ``grid`` (512 trials of (v_x, v_y) in (−3, 3)²), each with a final
   loss below its first; ``TPE`` (100 trials) through the GML facade;
   PatchEklt and PatchEkltDependent at the facades' defaults (4/2 patches:
   229,401 patches, 600 Adam steps; the angle and the poisson model), a
   warm-up and two timed frames each (bit-identical; PatchEklt's mean
   direction's cosine with −du > 0.5, the joint loss decreasing); CMax's
   translation model (16 bins) with ``random`` (512) and ``BFGS`` (40) in
   (−4, 4)² on the translating dots, within 0.5 px of their motion; one
   vote launch a solve, the host reads (L-BFGS's line search, TPE's
   trials) and the CUDA synchronisations counted per solve; the GML
   serving loop (``cli.evaluate_per_frames``, phase 6's loader, the
   ``configs/hot_plate1.yaml`` solver with ``method:
   generative_max_likelihood``: 3 parameters, two frames; one vote a frame
   for the IWE cache and one for the event mask; the first frame
   bit-identical to ``estimate_frame_gml`` on the same inputs and
   generator state; its flow one constant over the frame); small float64
   scenes of every new solver on the card and on the CPU within 1e-6;
12. the remaining ops and data at full width, on phase 6's loader (three
   consecutive windows of 523,264 events on integer sensor coordinates)
   with ``configs/hot_plate1.yaml``'s ``solver.filter.parameters`` and
   ``params_openpiv``: the exact device BAF with the time map carried,
   float64 keep masks and maps bit-identical to the native runtime, float32
   decisions differing only within 4 float32 ulps of ``BAF_dt``; the fast
   BAF and the flicker split card vs CPU bit for bit; HOT (a hot pixel
   injected) bit-identical to the native runtime at one vote launch;
   ``preprocess`` of ``Events`` with ``filters: [BAF, HOT]`` leaving the
   live events of ``preprocess`` of the array; the PIV on a full-width
   particle pair moved by (2.3, −1.7) px (64→8 over the 720×640 ROI: mean
   error a component < 0.1 px over the ROI interior) and a small float64
   scene card vs CPU ≤ 1e-9; ``cli.main`` with ``estimation_method:
   openpiv`` (outputs under ``build/chip_smoke_piv/``: two vote launches a
   pair, each histogram bit-identical to the plain vote, every flow and
   histogram PNG decoding at 720×1280) and one ``--eval`` frame with the
   PIV GT (its error texts); ``model_image: e2vid`` on an E2VID sequence
   written under ``build/chip_smoke_e2vid/`` (60 iterations, bit-identical
   to ``model_image: current`` on the decoded PNG); the voxel grid (5
   bins), the discretized volume (B = 10), the time image, the IWA (3 vote
   launches) and the bilinear, max, upwind and Burgers flow voxels (5
   bins), card vs CPU ≤ 1e-5 relative; each path's ms printed beside the
   card's name and power limit;
13. the wire and the mesh at full width, on phase 6's loader and solver
   section: one 523,264-event window uploaded directly, by the default
   upload (bit for bit the direct one) and by the t-less ``quantized_upload:
   true`` wire (x, y, p, valid bit for bit), with the bytes a window (16
   against 5 and 9 B/event) and each route's upload (+ decode) ms of CUDA
   events; phase 6's 3-frame serving loop with ``quantized_upload: true``
   and ``flow_fetch_dtype: float16`` (every flow within float16 rounding of
   phase 6's, the error texts within 2e-3 px and 0.05 for the nPE
   percentages, two vote launches a frame); ``cli.main`` with ``mesh:
   {data: 1, event: 1}`` on phase 6's frames (flows bit-identical to phase
   6's, a polarity-plane vote and the event mask a frame); the vote
   kernel against its plain version on a rank's half-capacity
   polarity-plane vote (bit for bit); four ranks sharing the card (a 2×2
   mesh over gloo, spawned) at 60 iterations: the batched step on 2
   frames, the multi-start with R = 4 over data 2 and 2 sequential lanes ×
   3 steps, each bit-identical to the same solves in this process from
   the same inits, with ms a step, the all-reduce of [2, 720, 1280]
   float32 planes through the host and 5 vote launches a rank.

Prints the whole run's seconds, a ``kernels`` JSON line, the
``nvidia-smi`` line, and last
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
    return launches, flow_np, statistics.median(frame_ms)


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


SERVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_serving")
SERVE_TEXTS = ("flow_error_per_frame_without_mask.txt",
               "flow_error_per_frame_with_mask.txt")


def serving_config(name, method="patch_eklt_pyramid2",
                   time_list=((0.01, 0.18),)):
    """Phase 6's config, as a user's YAML would give it (no YAML is read):
    ``configs/hot_plate1.yaml``'s ``solver``, ``common_params`` and
    ``params_opencv_flow`` values on the SYNTHETIC loader at 720×1280
    with ``bench.py``'s events per frame and displacement, serving
    (``visualize: false``), ``flow_convention: physical`` and ``profile:
    true``; ``time_list`` yields frames 1–3 of the 0.2 s recording.  The
    pyramid and GML take that solver section; the CMax method takes
    ``CmaxSpec``'s defaults (an empty solver section).
    Propagated as ``parse_args`` does."""
    from event_based_bos_tpu_torch.utils.config import propagate_config

    roi = dict(zip(("xmin", "xmax", "ymin", "ymax"), ROI))
    solver = {"filter": {"filters": None, "parameters": {}},
              "method": method}
    if method in ("patch_eklt_pyramid2", "generative_max_likelihood"):
        solver.update({
            "warp_direction": "first", "motion_model": "2d-translation",
            "parameters": ["trans_x", "trans_y"], "cost": "hybrid",
            "outer_padding": 0,
            "cost_with_weight": {"diff_norm": 1.0, "image_gradient": 0.5,
                                 "flow_norm_pxy": 0.1},
            "iwe": {"method": "bilinear_vote", "blur_sigma": 3},
            "optimizer": {"method": "Adam", "n_iter": N_ITER},
            "generative_ml": {
                "weight_loss_by_event_hist": False, "weight_sigma": 5,
                "weight_loss_by_inverse_event_hist": True,
                "optimize_warp": True, "iwe_sigma": 2,
                "no_polarity": False, "model_image": "current",
                "use_log_intensity": False, "poisson_model": True},
            "patch_eklt": {"coarsest_patch_size": 64,
                           "finest_patch_size": 8}})
    config = {
        "data": {"root": "", "dataset": "SYNTHETIC", "sequence": "plume0",
                 "height": H, "width": W, "duration": 0.2, "fps": 30,
                 "events_per_frame": CAPACITY - 1024,
                 "max_displacement": 3.0},
        "output_dir": os.path.join(SERVE_DIR, name),
        "evaluation": {"metrics": ["flow"],
                       "time_list": [list(t) for t in time_list]},
        "common_params": {"n_frames": 1, **roi},
        "solver": solver,
        "method": "opencv_flow", "estimation_method": "solver",
        "params_opencv_flow": {"pyr_scale": 0.5, "levels": 4, "winsize": 10,
                               "iterations": 3, "poly_n": 5,
                               "poly_sigma": 1.2, "flags": 0},
        "visualize": False, "flow_convention": "physical", "profile": True,
    }
    propagate_config(config)
    config["solver"].setdefault("flow_convention", config["flow_convention"])
    return config


class LoaderGroundTruth:
    """The GT of the serving loop from the synthetic loader's true flow
    (instead of Farnebäck): the frame pair's true displacement (row, col),
    cropped to the ROI and zero-padded like ``frame_flow._pad_flow``."""

    def __init__(self, loader, config):
        from event_based_bos_tpu_torch.cli import validate_image

        self.loader = loader
        self.crops = [validate_image(loader.load_image(i)[0],
                                     config["common_params"])
                      for i in range(loader.num_images)]

    def estimate(self, method, frame0, frame1, frame2, config):
        import numpy as np

        (i,) = [i for i, c in enumerate(self.crops)
                if np.array_equal(c, frame1)]
        gt = np.zeros((2, H, W))
        x0, x1, y0, y1 = ROI
        gt[:, x0:x1, y0:y1] = self.loader.load_optical_flow(i)[:, x0:x1,
                                                               y0:y1]
        return gt


class CallerLaunches:
    """Wraps module functions that vote (``name -> (module, attribute)``)
    to record, per caller, each call's arguments, result and the vote
    launches it made; :meth:`restore` unwraps them."""

    def __init__(self, callers):
        from event_based_bos_tpu_torch import kernels

        self.calls = {name: [] for name in callers}
        self._originals = []
        for name, (module, attr) in callers.items():
            fn = getattr(module, attr)

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                before = kernels.launches["hat_vote_image"]
                out = _fn(*args, **kwargs)
                self.calls[_name].append(
                    (args, kwargs, out,
                     kernels.launches["hat_vote_image"] - before))
                return out

            setattr(module, attr, wrapped)
            self._originals.append((module, attr, fn))

    def launches(self):
        return {name: sum(c[3] for c in calls)
                for name, calls in self.calls.items()}

    def restore(self):
        for module, attr, fn in self._originals:
            setattr(module, attr, fn)


def drive_serving(config, loader, device, gt_estimator, viz=None,
                  callers=None):
    """``cli.evaluate_per_frames`` on a solver built as ``cli.main`` builds
    it (with the Visualizer ``viz``, or serving), with the launch counts
    set to 0 just before and read just after, the vote launches counted per
    caller (``callers``: ``name -> (module, attribute)``, by default the
    IWE cache and the event mask), and the first frame's facade inputs and
    device flow recorded.  Returns ``(solver, launches, caller launches,
    records, ms/frame, log lines)``."""
    import logging
    import shutil

    import torch

    from event_based_bos_tpu_torch import cli, kernels, solver
    from event_based_bos_tpu_torch.solver import facades, programs

    if viz is None:
        shutil.rmtree(config["output_dir"], ignore_errors=True)
        os.makedirs(config["output_dir"])
    d = config["data"]
    solv = solver.collections[config["solver"]["method"]](
        (d["height"], d["width"]), (d["crop_height"], d["crop_width"]),
        calibration_parameter=loader.load_calib(),
        solver_config=config["solver"], visualize_module=viz,
        device=device)
    solv.output_dir = config["output_dir"]
    first = {}
    estimate_async = solv.estimate_async

    def recorded(events, *args, **kwargs):
        if not first:
            first.update(events=events, frame=kwargs["frame"],
                         state=solv._generator.get_state())
        handle = estimate_async(events, *args, **kwargs)
        first.setdefault("device_flow", getattr(handle, "device_flow",
                                                None))
        first.setdefault("handle", handle)
        return handle

    solv.estimate_async = recorded
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    log = logging.getLogger(cli.__name__)
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    callers = CallerLaunches(callers or {
        "iwe_cache": (facades, "iwe_cache"),
        "eventmask": (programs, "eventmask")})
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        cli.evaluate_per_frames(config, loader, solv, viz, device=device,
                                gt_estimator=gt_estimator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
    finally:
        callers.restore()
        log.removeHandler(handler)
        solv.estimate_async = estimate_async
    n_frames = solv.iter_cnt
    return (solv, launches, callers, first, 1e3 * wall / max(n_frames, 1),
            lines)


def check_serving_outputs(config, n_frames, zero_outside=True):
    """The serving loop's products: ``n_frames`` finite ``pred_flow{i}.npy``
    (with ``zero_outside``, −0.0 outside the ROI, as the pyramid solve's
    +0.0 is under ``physical``), and both error texts with ``n_frames``
    parsable lines and finite EPE.  Returns the EPE columns."""
    import numpy as np

    from event_based_bos_tpu_torch.utils import read_flow_error_text

    out = config["output_dir"]
    outside = np.ones((H, W), bool)
    outside[ROI[0]:ROI[1], ROI[2]:ROI[3]] = False
    for i in range(n_frames):
        f = np.load(os.path.join(out, f"pred_flow{i}.npy"))
        assert f.shape == (2, H, W) and np.isfinite(f).all(), i
        if not zero_outside:
            continue
        assert (f[:, outside] == 0).all(), f"pred_flow{i}: nonzero outside"
        assert np.signbit(f[:, outside]).all(), \
            f"pred_flow{i}: +0.0 outside the ROI under the physical convention"
        assert np.abs(f[:, ~outside]).max() > 0
    assert not os.path.exists(os.path.join(out, f"pred_flow{n_frames}.npy"))
    epe = {}
    for name in SERVE_TEXTS:
        arrays, stats = read_flow_error_text(os.path.join(out, name))
        assert stats["EPE"]["n_data"] == n_frames, (name, stats["EPE"])
        assert np.isfinite(arrays["EPE"]).all(), (name, arrays["EPE"])
        epe[name] = [float(v) for v in arrays["EPE"]]
    return epe


def zero_flow_epe(loader, frames):
    """The error texts' unmasked EPE of a zero flow against the loader's
    true flow of each frame in ``frames`` (the ROI crop)."""
    import torch

    from event_based_bos_tpu_torch.ops.flow import calculate_flow_error

    x0, x1, y0, y1 = ROI
    out = []
    for i in frames:
        gt = torch.as_tensor(loader.load_optical_flow(i)[:, x0:x1, y0:y1],
                             dtype=torch.float32)[None]
        out.append(float(calculate_flow_error(gt, torch.zeros_like(gt))[
            "EPE"]))
    return out


def section_shares(lines, n_frames):
    """``{section: [s/frame, share %]}`` from the loop's ``profile`` log:
    the steady-state report (frames 3+) when the loop logged one, else
    the whole run's report divided by ``n_frames``; and the report's
    header line."""
    steady = [m for m in lines if m.startswith("Steady-state sections")]
    whole = [m for m in lines if m.startswith("Per-section host timings")]
    assert steady or whole, "profile: true logged no section report"
    head, *rows = (steady or whole)[-1].splitlines()
    div = 1 if steady else n_frames
    shares = {}
    for row in rows:
        name, rest = row.split(": ", 1)
        value, share = rest.split(" (")
        shares[name] = [float(value.split("s")[0]) / div,
                        float(share.rstrip("%)"))]
    return head, shares


def run_serving(device):
    """Phase 6: the serving loop at full width, pyramid then CMax."""
    import importlib.util

    import numpy as np
    import torch

    from event_based_bos_tpu_torch import data, kernels
    from event_based_bos_tpu_torch.ops import iwe_cuda
    from event_based_bos_tpu_torch.solver.cmax import scale_iterations
    from event_based_bos_tpu_torch.solver.generative import iwe_cache
    from event_based_bos_tpu_torch.solver.pyramid import estimate_frame

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("cv2", "yaml")}
    print(f"serving: host packages cv2 {have['cv2']}, yaml {have['yaml']}")
    dev = torch.device(device)
    config = serving_config("pyramid")
    t0 = time.perf_counter()
    loader = data.collections["SYNTHETIC"](config=config["data"])
    loader.set_sequence(config["data"]["sequence"])
    gt = LoaderGroundTruth(loader, config)
    print(f"serving: SYNTHETIC {H}x{W}, {loader.num_images} frames, "
          f"{len(loader)} events ({time.perf_counter() - t0:.1f} s to "
          f"generate)")
    results = {}

    solv, launches, callers, first, ms, lines = drive_serving(
        config, loader, device, gt)
    n = solv.iter_cnt
    per_caller = callers.launches()
    epe = check_serving_outputs(config, 3)
    zero_epe = zero_flow_epe(loader, (1, 2, 3))
    head, shares = section_shares(lines, n)
    assert n == 3, f"{n} frames served, expected 3"
    assert per_caller == {"iwe_cache": 3, "eventmask": 3}, per_caller
    assert all(c[3] == 1 for calls in callers.calls.values()
               for c in calls), "a caller voted more than once a call"
    assert launches["hat_vote_image"] == 6, launches
    # the facade's first frame, solved directly on the same filtered
    # events, frame and generator state
    gen = torch.Generator(dev)
    gen.set_state(first["state"])
    frame = torch.as_tensor(first["frame"], dtype=solv.dtype, device=dev)
    direct, _ = estimate_frame(None, frame, solv._mask, gen, solv.spec,
                               cache=iwe_cache(first["events"], solv.gen),
                               device=dev)
    same_flow = torch.equal(direct, first["device_flow"])
    # the event mask's vote at the loop's arguments vs its plain version
    ev = callers.calls["eventmask"][0][0][0]
    kernel_vote = iwe_cuda.bilinear_vote_cuda(ev, (H, W), nudge=True)
    plain_vote = iwe_cuda.hat_vote_plain(
        ev.x.to(torch.float32), ev.y.to(torch.float32), None, (H, W),
        valid=ev.valid, nudge=True)
    mask_err = float((kernel_vote - plain_vote).abs().max())
    mask_same = (torch.equal(kernel_vote, plain_vote) and torch.equal(
        callers.calls["eventmask"][0][2], (plain_vote != 0)[None]))
    kernels.reset_launches()
    print(f"serving pyramid: {n} frames, {ms:.1f} ms/frame (wall clock); "
          f"vote launches {launches['hat_vote_image']} ({per_caller}); "
          f"EPE per frame without mask {epe[SERVE_TEXTS[0]]}, with mask "
          f"{epe[SERVE_TEXTS[1]]} (zero flow without mask {zero_epe}); "
          f"first frame bit-identical to "
          f"estimate_frame {same_flow}; event-mask vote vs plain "
          f"max|diff| {mask_err:.3e}, bit-identical {mask_same}")
    print(f"serving pyramid profile: {head}: {shares}")
    assert same_flow, "the facade's flow differs from estimate_frame's"
    assert mask_same, "the event-mask vote differs from its plain version"
    results["pyramid"] = dict(ms_per_frame=ms, frames=n, steady=head,
                              sections=shares, vote_launches=per_caller,
                              vote_launches_per_frame={
                                  k: v / n for k, v in per_caller.items()},
                              epe=epe, zero_flow_epe=zero_epe)
    del solv, first, callers

    cconfig = serving_config("cmax", method="contrast_maximization",
                             time_list=((0.01, 0.15),))
    solv, launches, callers, _first, ms, lines = drive_serving(
        cconfig, loader, device, gt)
    n = solv.iter_cnt
    steps = sum(scale_iterations(solv.spec))
    per_caller = callers.launches()
    # the CMax flow is the pattern displacement over the widened ROI box
    epe = check_serving_outputs(cconfig, 2, zero_outside=False)
    head, shares = section_shares(lines, n)
    print(f"serving cmax: {n} frames, {ms:.1f} ms/frame (wall clock); "
          f"launches {launches} (event mask {per_caller['eventmask']}); "
          f"EPE per frame without mask {epe[SERVE_TEXTS[0]]}")
    print(f"serving cmax profile: {head}: {shares}")
    assert solv.spec == cmax_cell_spec(), solv.spec
    assert n == 2 and steps == 260, (n, steps)
    assert per_caller["eventmask"] == 2, per_caller
    assert launches == {"hat_vote_image": 4, "cmax_stencil_fwd": 520,
                        "cmax_stencil_bwd": 520}, launches
    results["cmax"] = dict(ms_per_frame=ms, frames=n, steady=head,
                           sections=shares, launches=launches,
                           launches_per_frame={k: v / n for k, v in
                                               launches.items()},
                           epe=epe)
    kernels.reset_launches()

    if have["cv2"]:
        # one frame with the default Farnebäck GT
        fconfig = serving_config("farneback", time_list=((0.01, 0.11),))
        _solv, _l, callers, _f, ms, _lines = drive_serving(fconfig, loader,
                                                           device, None)
        epe = check_serving_outputs(fconfig, 1)
        print(f"serving pyramid, Farnebäck GT: 1 frame, {ms:.1f} ms; EPE "
              f"against Farnebäck without mask {epe[SERVE_TEXTS[0]]}, with "
              f"mask {epe[SERVE_TEXTS[1]]}")
        results["farneback"] = dict(ms_per_frame=ms, epe=epe)
        kernels.reset_launches()
    print(json.dumps({"serving": results}))
    return results, mask_err, loader, gt


VIZ_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "chip_smoke_visualize")
FRAME_PNGS = ("original", "original_filter", "pred_flow", "pred_flow_poisson",
              "pred_masked", "gt_flow", "gt_flow_poisson", "gt_masked",
              "flow_comparison_pred", "flow_comparison_gt")
PREFIX_VIDEOS = ("original", "original_filter", "pred_flow",
                 "pred_flow_poisson", "pred_masked", "gt_flow",
                 "gt_flow_poisson", "gt_masked")
COMPARISON_VIDEOS = ("flow_comparison", "flow_comparison_masked",
                     "video_filter_effect")


def visualize_config(name, solver="patch_eklt_pyramid2",
                     time_list=((0.01, 0.18),), **top):
    """Phase 6's config with ``visualize: true``, its own output directory
    under ``VIZ_DIR`` and the top-level keys ``top``."""
    config = serving_config(name, method=solver, time_list=time_list)
    config.update(visualize=True, output_dir=os.path.join(VIZ_DIR, name),
                  **top)
    return config


def new_visualizer(config, device):
    """The Visualizer ``cli.main`` builds, in a fresh output directory."""
    import shutil

    from event_based_bos_tpu_torch.visualizer import Visualizer

    shutil.rmtree(config["output_dir"], ignore_errors=True)
    return Visualizer((H, W), save=True, show=False,
                      save_dir=config["output_dir"], async_writes=True,
                      device=device)


def check_pngs(out, names):
    """Every PNG in ``names`` exists and decodes at H×W."""
    import cv2

    for name in names:
        img = cv2.imread(os.path.join(out, name), cv2.IMREAD_UNCHANGED)
        assert img is not None, f"{name} missing or unreadable"
        assert img.shape[:2] == (H, W), (name, img.shape)


def check_videos(out, prefixes, n_frames):
    """``{prefix: frames}`` of the mp4s written (an mp4 exists only where
    cv2 has a codec); each written one decodes at H×W (the comparison
    videos wider) with ``n_frames`` frames."""
    import cv2

    written = {}
    for prefix in prefixes:
        path = os.path.join(out, f"{prefix}.mp4")
        if not os.path.exists(path):
            continue
        cap = cv2.VideoCapture(path)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        ok, frame = cap.read()
        cap.release()
        assert ok and frame.shape[0] == H and frame.shape[1] % W == 0, prefix
        assert n == n_frames, (prefix, n, n_frames)
        written[prefix] = n
    return written


def codec_available():
    import cv2

    path = os.path.join(VIZ_DIR, "codec_probe.mp4")
    os.makedirs(VIZ_DIR, exist_ok=True)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 20.0, (64, 64))
    ok = w.isOpened()
    w.release()
    if os.path.exists(path):
        os.remove(path)
    return ok


def plain_clipped_and_mask(ev, max_scale):
    """The bundle's clipped IWE and event mask from the plain vote."""
    import torch

    from event_based_bos_tpu_torch.ops import iwe_cuda

    vote = iwe_cuda.hat_vote_plain(ev.x.to(torch.float32),
                                   ev.y.to(torch.float32), None, (H, W),
                                   valid=ev.valid, nudge=True)
    clipped = 255 - torch.clamp(max_scale * vote, 0, 255).to(torch.uint8)
    return clipped, (vote != 0)[None]


def run_visualize(device, loader, gt):
    """Phase 7: the visualizing loop at full width (the default of every
    shipped config), then the run modes without ``--eval`` and the
    two-step GT."""
    import importlib.util
    import logging

    import numpy as np
    import torch

    from event_based_bos_tpu_torch import cli, kernels
    from event_based_bos_tpu_torch.ops.poisson import poisson_view
    from event_based_bos_tpu_torch.solver import cmax, facades, programs

    codec = codec_available()
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    print(f"visualize: mp4 codec {codec}, matplotlib {have_mpl}")
    viz_log = []
    handler = logging.Handler()
    handler.emit = lambda record: viz_log.append(record.getMessage())
    logging.getLogger("event_based_bos_tpu_torch.visualizer").addHandler(
        handler)
    results = {}
    bundle_callers = {"bundle_clipped": (programs, "clipped_iwe"),
                      "bundle_mask": (programs, "eventmask"),
                      "render_bundle": (programs, "render_bundle")}

    # the pyramid: phase 6's config and frames, visualizing
    config = visualize_config("pyramid")
    viz = new_visualizer(config, device)
    solv, launches, callers, first, ms, lines = drive_serving(
        config, loader, device, gt, viz=viz,
        callers={"iwe_cache": (facades, "iwe_cache"), **bundle_callers})
    n = solv.iter_cnt
    t0 = time.perf_counter()
    cli.write_videos(viz, solv)
    videos_s = time.perf_counter() - t0
    out = config["output_dir"]
    per_caller = callers.launches()
    bundle_votes = per_caller.pop("render_bundle")
    head, shares = section_shares(lines, n)
    assert n == 3, f"{n} frames, expected 3"
    assert per_caller == {"iwe_cache": n, "bundle_clipped": n,
                          "bundle_mask": n}, per_caller
    assert bundle_votes == 2 * n and launches["hat_vote_image"] == 3 * n, \
        (bundle_votes, launches)
    check_pngs(out, [f"{p}{i}.png" for p in FRAME_PNGS for i in range(n)])
    videos = check_videos(out, PREFIX_VIDEOS, n)
    videos.update(check_videos(out, COMPARISON_VIDEOS, n))
    assert bool(videos) == codec, (videos, codec)
    if codec:
        assert set(videos) == set(PREFIX_VIDEOS + COMPARISON_VIDEOS), videos
    plots = sorted(f for f in os.listdir(out)
                   if f.startswith("optimization_steps"))
    assert len(plots) == (n if have_mpl else 0), plots
    same = []
    for i in range(n):
        a = np.load(os.path.join(out, f"pred_flow{i}.npy"))
        b = np.load(os.path.join(SERVE_DIR, "pyramid", f"pred_flow{i}.npy"))
        same.append(a.dtype == b.dtype and a.tobytes() == b.tobytes())
    # the bundle's votes against the plain vote, at the loop's arguments
    (ev, _shape, max_scale), _kw, clipped, _l = callers.calls[
        "bundle_clipped"][0]
    plain_clipped, plain_mask = plain_clipped_and_mask(ev, max_scale)
    mask = callers.calls["bundle_mask"][0][2]
    bundle_exact = (torch.equal(clipped, plain_clipped)
                    and torch.equal(mask, plain_mask))
    # the bundle's and the Poisson views' device time on frame 0's inputs
    b_args, b_kw = callers.calls["render_bundle"][0][:2]
    flush = l2_flush(torch.device(device))
    bundle_ms = cuda_ms(lambda: programs.render_bundle(*b_args, **b_kw),
                        flush=flush)
    est_scaled = b_args[1].to(torch.float32) * float(np.float32(b_args[5]))
    poisson_ms = cuda_ms(lambda: poisson_view(est_scaled), flush=flush)
    kernels.reset_launches()
    print(f"visualize pyramid: {n} frames, {ms:.1f} ms/frame (wall clock; "
          f"videos after the loop {videos_s:.2f} s); vote launches "
          f"{launches['hat_vote_image']} ({per_caller}); pred_flow{{i}}.npy "
          f"bit-identical to phase 6's {same}; bundle clipped IWE and mask "
          f"bit-exact vs the plain vote {bundle_exact}; render_bundle "
          f"{bundle_ms:.3f} ms device, one Poisson view {poisson_ms:.3f} ms "
          f"device (median of 20, L2 flushed); mp4s {videos or 'none'}; "
          f"history plots {plots or 'none'}")
    print(f"visualize pyramid profile: {head}: {shares}")
    assert all(same), f"the visualizing loop's flows differ from phase 6's"
    assert bundle_exact, "the bundle's votes differ from the plain vote"
    results["pyramid"] = dict(
        ms_per_frame=ms, frames=n, steady=head, sections=shares,
        vote_launches=per_caller, bundle_ms=bundle_ms,
        poisson_ms=poisson_ms, videos=videos, videos_s=videos_s,
        flows_equal_serving=same)
    del solv, first, callers

    # one CMax frame, visualizing (the bundle from the host flow)
    config = visualize_config("cmax", solver="contrast_maximization",
                              time_list=((0.01, 0.11),))
    viz = new_visualizer(config, device)
    solv, launches, callers, _first, ms, lines = drive_serving(
        config, loader, device, gt, viz=viz,
        callers={"histograms": (cmax, "binned_histograms"),
                 **bundle_callers})
    cli.write_videos(viz, solv)
    per_caller = callers.launches()
    per_caller.pop("render_bundle")
    check_pngs(config["output_dir"], [f"{p}0.png" for p in FRAME_PNGS])
    print(f"visualize cmax: 1 frame, {ms:.1f} ms; launches {launches} "
          f"({per_caller})")
    assert solv.iter_cnt == 1
    assert per_caller == {"histograms": 1, "bundle_clipped": 1,
                          "bundle_mask": 1}, per_caller
    assert launches == {"hat_vote_image": 3, "cmax_stencil_fwd": 260,
                        "cmax_stencil_bwd": 260}, launches
    results["cmax"] = dict(ms_per_frame=ms, launches=launches)
    kernels.reset_launches()

    # the run modes without --eval over two 10 ms windows
    for mode, fn, pngs, votes in (
            ("accumulate", cli.accumulate_sequential, ("orig", "filter"), 4),
            ("sequential", cli.estimate_sequential,
             ("original", "original_filter"), 2)):
        config = visualize_config(mode, time_list=((0.01, 0.03),))
        viz = new_visualizer(config, device)
        d = config["data"]
        solv = facades.collections[config["solver"]["method"]](
            (H, W), (d["crop_height"], d["crop_width"]),
            solver_config=config["solver"], visualize_module=viz,
            device=device)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        fn(config, loader, solv)
        cli.write_videos(viz, solv)
        wall = time.perf_counter() - t0
        got = dict(kernels.launches)
        check_pngs(config["output_dir"],
                   [f"{p}{i}.png" for p in pngs for i in range(2)])
        mode_videos = check_videos(config["output_dir"],
                                   PREFIX_VIDEOS[:2], 2)
        print(f"visualize {mode} (2 windows): {wall:.2f} s, vote launches "
              f"{got['hat_vote_image']}, mp4s {mode_videos or 'none'}")
        assert got["hat_vote_image"] == votes, (mode, got)
        results[mode] = dict(s=wall, vote_launches=got["hat_vote_image"])
        kernels.reset_launches()

    # one frame with the two-step Farnebäck GT (its Poisson views on the
    # card), visualizing
    config = visualize_config("two_step", time_list=((0.01, 0.11),),
                              method="opencv_flow_two_steps")
    viz = new_visualizer(config, device)
    solv, launches, _c, _f, ms, _lines = drive_serving(config, loader,
                                                       device, None, viz=viz)
    cli.write_videos(viz, solv)
    epe = check_serving_outputs(config, 1)
    check_pngs(config["output_dir"], [f"{p}0.png" for p in FRAME_PNGS])
    print(f"visualize, two-step GT: 1 frame, {ms:.1f} ms; EPE against the "
          f"two-step GT without mask {epe[SERVE_TEXTS[0]]}, with mask "
          f"{epe[SERVE_TEXTS[1]]}; vote launches {launches['hat_vote_image']}")
    assert launches["hat_vote_image"] == 3, launches
    results["two_step"] = dict(ms_per_frame=ms, epe=epe)
    kernels.reset_launches()

    warned = [m for m in viz_log if "matplotlib" in m]
    print(f"visualizer warnings: {warned or 'none'}")
    assert bool(warned) == (not have_mpl), warned
    logging.getLogger("event_based_bos_tpu_torch.visualizer").removeHandler(
        handler)
    print(json.dumps({"visualize": results}))
    return results


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "goldens", "pyramid_720x1280_ref_flow.npy")
GOLDEN_ITERS = 40           # 8/10/13/20 Adam steps a scale
GOLDEN_MSE, GOLDEN_CORR = 2e-2, 0.95


def check_golden(device):
    """Phase 8: the original reference's ``PatchEkltPyramid2`` at 720×1280
    (``tests/goldens/pyramid_720x1280_ref_flow.npy``: float64, 40
    iterations, pinned init) against the port's ``estimate_frame`` on the
    same scene from the same init, over the ROI, at the JAX package's own
    limits (MSE < 2e-2, correlation > 0.95)."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import events_from_ndarray
    from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                          generate_sequence)
    from event_based_bos_tpu_torch.solver import GenerativeSpec, PyramidSpec
    from event_based_bos_tpu_torch.solver.pyramid import (estimate_frame,
                                                          pyramid_grids,
                                                          roi_mask)

    # the golden's scene (seed 0, the bench physics) and its pinned init
    # (one uniform [-1, 1) plane a scale from seed 2)
    seq = generate_sequence(SyntheticBosConfig(
        height=H, width=W, duration=1.0 / 30.0, fps=30.0,
        events_per_frame=CAPACITY - 1024, max_displacement=3.0,
        plume_speed=900.0, seed=0))
    gen = GenerativeSpec(image_size=(H, W), iwe_sigma=2.0,
                         weight_by_inverse_event_hist=True,
                         optimize_warp=True, poisson_model=True,
                         dtype=torch.float64)
    spec = PyramidSpec(gen=gen, roi=ROI, coarsest_patch=64, finest_patch=8,
                       n_iter=GOLDEN_ITERS)
    rng = np.random.default_rng(2)
    prev = []
    for g in pyramid_grids(spec):
        p = np.zeros((3,) + g.shape)
        p[0] = rng.uniform(-1, 1, g.shape)
        prev.append(p)
    dev = torch.device(device)
    ev = events_from_ndarray(seq["events"], capacity=CAPACITY,
                             dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow, _aux = estimate_frame(ev, seq["frames"][1],
                                roi_mask(spec, torch.float64), None, spec,
                                prev_params=prev, device=dev)
    flow = flow.cpu().numpy()
    solve_s = time.perf_counter() - t0
    ref = np.load(GOLDEN)
    with open(GOLDEN.replace("_ref_flow.npy", "_meta.json")) as f:
        meta = json.load(f)
    crop = (slice(None), slice(ROI[0], ROI[1]), slice(ROI[2], ROI[3]))
    mse = float(np.mean((flow[crop] - ref[crop]) ** 2))
    corr = float(np.corrcoef(flow[crop].ravel(), ref[crop].ravel())[0, 1])
    print(f"golden parity ({H}x{W}, float64, {GOLDEN_ITERS} iterations, "
          f"pinned init; solve {solve_s:.1f} s): MSE {mse:.4e} ({mse!r}), "
          f"correlation {corr:.4f} ({corr!r}); limits < {GOLDEN_MSE:g}, > "
          f"{GOLDEN_CORR:g}; the JAX package measured MSE "
          f"{meta['flow_mse']:.4e}, correlation {meta['flow_corr']:.4f}")
    assert np.isfinite(flow).all() and flow.shape == ref.shape
    assert mse < GOLDEN_MSE, f"golden MSE {mse} ≥ {GOLDEN_MSE}"
    assert corr > GOLDEN_CORR, f"golden correlation {corr} ≤ {GOLDEN_CORR}"
    return {"mse": mse, "corr": corr, "solve_s": solve_s,
            "jax_mse": meta["flow_mse"], "jax_corr": meta["flow_corr"]}


def flow_corr(a, b):
    """Correlation of two flows over the ROI."""
    import numpy as np

    x0, x1, y0, y1 = ROI
    a = np.asarray(a, np.float64)[:, x0:x1, y0:y1].ravel()
    b = np.asarray(b, np.float64)[:, x0:x1, y0:y1].ravel()
    return float(np.corrcoef(a, b)[0, 1])


RESTART_ITERS = 60
N_RESTARTS = 3


def run_pyramid_modes(events, frame, gt_flow, main_flow, main_ms, device):
    """Phase 9: the pyramid's modes at full width on phase 4's workload,
    spec and seed: ``restrict_to_roi`` (stride 4; a warm-up and three timed
    frames, beside phase 4's ms/frame), with ``compute_dtype: bfloat16``,
    ``warp_compute_bf16`` alone, and ``n_restarts = 3`` at 60 iterations
    against the best of three single solves from the same draws."""
    import dataclasses

    import torch

    from event_based_bos_tpu_torch import events_from_ndarray, kernels
    from event_based_bos_tpu_torch.solver import GenerativeSpec, PyramidSpec
    from event_based_bos_tpu_torch.solver.generative import (
        initialize_params, iwe_cache)
    from event_based_bos_tpu_torch.solver.pyramid import (estimate_frame,
                                                          pyramid_grids,
                                                          restart_scores,
                                                          roi_mask)

    dev = torch.device(device)
    gen = GenerativeSpec(image_size=(H, W), iwe_sigma=2.0,
                         weight_by_inverse_event_hist=True,
                         optimize_warp=True, poisson_model=True)
    full = PyramidSpec(gen=gen, roi=ROI, coarsest_patch=64, finest_patch=8,
                       n_iter=N_ITER)
    ev = events_from_ndarray(events, capacity=CAPACITY, device=dev)
    frame_t = torch.as_tensor(frame, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(roi_mask(full), device=dev)

    def solve(spec, seed=0, init=None):
        cache = iwe_cache(ev, spec.gen)
        return estimate_frame(None, frame_t, mask,
                              torch.Generator(dev).manual_seed(seed), spec,
                              init_params=init, cache=cache, device=dev)

    restricted = dataclasses.replace(full, restrict_to_roi=True,
                                     roi_norm_stride=4)
    bf16 = dataclasses.replace(restricted, gen=dataclasses.replace(
        gen, compute_dtype=torch.bfloat16))
    warp_bf16 = dataclasses.replace(full, gen=dataclasses.replace(
        gen, warp_compute_bf16=True))

    # each mode's objective against the full-frame float32 one at the same
    # start: the first loss of a short solve from the same init
    first = {}
    for name, spec in (("full", full), ("restricted", restricted),
                       ("restricted + bfloat16", bf16),
                       ("warp_compute_bf16", warp_bf16)):
        _flow, aux = solve(dataclasses.replace(spec, n_iter=5))
        first[name] = float(aux["loss_history"][0][0])
    gaps = {name: abs(v - first["full"]) / first["full"]
            for name, v in first.items() if name != "full"}
    print(f"pyramid modes: first loss from the same init {first}; relative "
          f"gap to the full-frame float32 objective "
          f"{ {k: float(f'{v:.3e}') for k, v in gaps.items()} } (limit 1e-2)")
    assert all(v <= 1e-2 for v in gaps.values()), gaps

    torch.cuda.synchronize()
    kernels.reset_launches()
    solve(restricted)
    torch.cuda.synchronize()
    frame_ms, flows = [], []
    for _ in range(3):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        flow, _aux = solve(restricted)
        e.record()
        e.synchronize()
        frame_ms.append(s.elapsed_time(e))
        flows.append(flow)
    votes = kernels.launches["hat_vote_image"]
    repeatable = all(torch.equal(f, flows[0]) for f in flows[1:])
    r_flow = flows[0].cpu().numpy()
    r_epe = accuracy_epe(r_flow, gt_flow)
    r_corr = flow_corr(r_flow, main_flow)
    r_ms = statistics.median(frame_ms)
    # the correlation with another mode's flow from one init is printed
    # with no limit: over 770 Adam steps any perturbation decorrelates the
    # flows (the JAX package's own restricted and full solves at this
    # size: 0.58 on the CPU), while the EPE stays
    print(f"pyramid modes: restrict_to_roi (stride 4) {r_ms:.1f} ms/frame "
          f"(frames {', '.join(f'{t:.1f}' for t in frame_ms)}) beside phase "
          f"4's {main_ms:.1f}, EPE {r_epe:.4f} px ({r_epe!r}), correlation "
          f"with phase 4's flow {r_corr:.5f}, vote launches {votes} in 4 "
          f"frames, timed frames bit-identical {repeatable}")
    check_flow(r_flow)
    assert repeatable, "the restricted frames differ"
    assert votes == 4, f"{votes} vote launches in 4 restricted frames"
    assert r_epe < EPE_LIMIT, f"restricted EPE {r_epe:.4f} ≥ {EPE_LIMIT}"
    results = {"restricted_ms": r_ms, "main_ms": main_ms}

    for name, spec, ref_flow in (
            ("restrict_to_roi + bfloat16", bf16, r_flow),
            ("warp_compute_bf16", warp_bf16, main_flow)):
        kernels.reset_launches()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        flow, aux = solve(spec)
        e.record()
        e.synchronize()
        flow_np = flow.cpu().numpy()
        epe = accuracy_epe(flow_np, gt_flow)
        corr = flow_corr(flow_np, ref_flow)
        print(f"pyramid modes: {name} {s.elapsed_time(e):.1f} ms (one "
              f"frame), EPE {epe:.4f} px ({epe!r}), correlation "
              f"with the float32 flow {corr:.5f}, vote launches "
              f"{kernels.launches['hat_vote_image']}, flow "
              f"{flow.dtype}, parameters {aux['params_per_scale'][-1].dtype}")
        check_flow(flow_np)
        assert kernels.launches["hat_vote_image"] == 1
        assert flow.dtype == torch.float32
        assert epe < EPE_LIMIT, f"{name}: EPE {epe:.4f} ≥ {EPE_LIMIT}"
        results[name] = s.elapsed_time(e)
    check_small_restricted(device)

    # the multi-start from one generator against the best of the single
    # solves from the same three draws
    multi = dataclasses.replace(full, n_iter=RESTART_ITERS,
                                n_restarts=N_RESTARTS)
    kernels.reset_launches()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    flow, aux = solve(multi, seed=1)
    e.record()
    e.synchronize()
    m_votes = kernels.launches["hat_vote_image"]
    g = torch.Generator(dev).manual_seed(1)
    inits = [initialize_params(g, pyramid_grids(multi)[0].shape, gen, dev)
             for _ in range(N_RESTARTS)]
    single = dataclasses.replace(multi, n_restarts=1)
    lanes = [solve(single, init=x0) for x0 in inits]
    scores = restart_scores(lanes, single.track_best).cpu().tolist()
    best = min(range(N_RESTARTS), key=lambda i: (scores[i], i))
    same = torch.equal(flow, lanes[best][0])
    print(f"pyramid modes: n_restarts {N_RESTARTS} at {RESTART_ITERS} "
          f"iterations {s.elapsed_time(e):.1f} ms, lane scores "
          f"{[round(v, 6) for v in scores]}, best lane {best}, flow "
          f"bit-identical to that lane's single solve {same}, vote launches "
          f"{m_votes}")
    assert m_votes == 1, f"{m_votes} vote launches in one multi-start frame"
    assert same, "the multi-start flow is not its best lane's"
    results["votes"] = votes + 2 + m_votes
    results["multistart_ms"] = s.elapsed_time(e)
    return results


def check_small_restricted(device):
    """Phase 9: small float64 restricted solves on the card and on the CPU
    must agree, at an ROI of the full height and at one open on all four
    sides."""
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
    init = np.zeros((3, 4, 6))
    init[0] = np.random.default_rng(0).uniform(-1, 1, (4, 6))
    errs = []
    for roi in ((0, 64, 16, 80), (12, 52, 20, 76)):
        spec = PyramidSpec(gen=gen, roi=roi, coarsest_patch=16,
                           finest_patch=8, n_iter=24, restrict_to_roi=True)
        flows = []
        for dev in (device, "cpu"):
            ev = events_from_ndarray(seq["events"], capacity=4096,
                                     device=dev)
            flow, _ = estimate_frame(ev, seq["frames"][1], roi_mask(spec),
                                     None, spec, init_params=init,
                                     device=dev)
            flows.append(flow.cpu())
        errs.append(float((flows[0] - flows[1]).abs().max()))
    print(f"pyramid modes: small float64 restricted scenes, card vs CPU: "
          f"max|flow diff| {errs[0]:.3e} (full-height ROI), {errs[1]:.3e} "
          f"(four-sided ROI) (limit 1e-6)")
    assert max(errs) <= 1e-6, errs


def check_flow(flow):
    """A full-frame flow: finite, exactly +0.0 outside the ROI."""
    import numpy as np

    outside = np.ones((H, W), bool)
    outside[ROI[0]:ROI[1], ROI[2]:ROI[3]] = False
    assert flow.shape == (2, H, W) and np.isfinite(flow).all()
    assert (flow[:, outside] == 0).all(), "nonzero flow outside the ROI"
    assert not np.signbit(flow[:, outside]).any(), "−0.0 outside the ROI"
    assert np.abs(flow[:, ~outside]).max() > 0


CCS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_ccs")
CCS_DURATION = 0.2
CCS_TIME_LIST = [[0.03, 0.15]]
CCS_HOMOGRAPHY = ((1.01, 0.004, -3.0), (0.002, 0.99, 2.5), (2e-6, 0.0, 1.0))


def evt3_words(x, y, t_us, p):
    """A Prophesee EVT3 word stream of time-sorted events (sensor x =
    column, y = row, µs, polarity), vectorized: per event TIME_HIGH (0x8)
    and TIME_LOW (0x6) where they change, ADDR_Y (0x0) on a row change and
    one ADDR_X (0x2, bit 11 = polarity)."""
    import numpy as np

    t = np.asarray(t_us, np.int64)
    assert t.max() < (1 << 24)
    th, tl = (t >> 12) & 0xFFF, t & 0xFFF
    y = np.asarray(y, np.int64)
    c_h = th != np.r_[0, th[:-1]]
    c_l = tl != np.r_[0, tl[:-1]]
    c_y = y != np.r_[-1, y[:-1]]
    counts = 1 + c_h.astype(np.int64) + c_l + c_y
    pos = 2 + np.cumsum(counts) - counts
    words = np.empty(2 + int(counts.sum()), np.uint16)
    words[:2] = (0x8 << 12, 0x6 << 12)
    for flag, word in ((c_h, (0x8 << 12) | th), (c_l, (0x6 << 12) | tl),
                       (c_y, y)):
        words[pos[flag]] = word[flag]
        pos = pos + flag
    words[pos] = ((0x2 << 12) | (np.asarray(p, np.int64) << 11)
                  | np.asarray(x, np.int64))
    return words


def write_ccs_recording(root, formats):
    """The port's synthetic scene at 720×1280 with ``bench.py``'s events a
    frame, in the CCS layout of ``configs/hot_plate1.yaml``'s sequence
    under ``root/<format>/CCS/hot_plate1``: events as a raw EVT3 capture
    and/or HDF5, trigger edges, a non-identity homography, ``frames.mp4``
    (``mp4v``).  Returns ``{format: data root}``."""
    import shutil

    import cv2
    import numpy as np

    from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                          generate_sequence)

    seq = generate_sequence(SyntheticBosConfig(
        height=H, width=W, duration=CCS_DURATION, fps=30.0,
        events_per_frame=CAPACITY - 1024, max_displacement=3.0, seed=0))
    ev = seq["events"]
    ev = ev[np.argsort(ev[:, 2], kind="stable")]
    xs, ys = ev[:, 1].astype(np.int16), ev[:, 0].astype(np.int16)
    ts = (ev[:, 2] * 1e6).astype(np.int32)
    ps = ev[:, 3] > 0
    roots = {}
    for fmt in formats:
        shutil.rmtree(os.path.join(root, fmt), ignore_errors=True)
        data_root = os.path.join(root, fmt, "datasets")
        d = os.path.join(data_root, "CCS", "hot_plate1")
        os.makedirs(os.path.join(d, "prophesee_0"))
        os.makedirs(os.path.join(d, "basler_0"))
        if fmt == "hdf5":
            import h5py

            with h5py.File(os.path.join(d, "prophesee_0", "events.hdf5"),
                           "w") as f:
                g = f.create_group("raw_events")
                for k, v in (("x", xs), ("y", ys), ("t", ts), ("p", ps)):
                    g.create_dataset(k, data=v)
        else:
            with open(os.path.join(d, "prophesee_0", "cd_events.raw"),
                      "wb") as f:
                f.write(b"% evt 3.0\n% end\n")
                f.write(evt3_words(xs, ys, ts, ps).tobytes())
        ft = seq["frame_ts"]
        np.savetxt(os.path.join(d, "prophesee_0", "trigger_events.txt"),
                   np.stack([(ft * 1e6).astype(int), np.zeros(len(ft), int),
                             np.ones(len(ft), int)], 1), fmt="%d")
        np.savetxt(os.path.join(d, "homography.txt"),
                   np.asarray(CCS_HOMOGRAPHY))
        vw = cv2.VideoWriter(os.path.join(d, "basler_0", "frames.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
        assert vw.isOpened(), "no mp4v codec for the recording"
        for fr in seq["frames"]:
            vw.write(cv2.cvtColor(fr.astype(np.uint8), cv2.COLOR_GRAY2BGR))
        vw.release()
        roots[fmt] = data_root
    return roots, len(ev)


def hot_plate_copy(root, out_dir, filters=None):
    """``configs/hot_plate1.yaml`` with only ``data.root``, ``output_dir``
    and ``time_list`` changed (and, for the second run, the filter list),
    written beside its outputs."""
    import yaml

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, "configs", "hot_plate1.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["root"] = root
    cfg["output_dir"] = out_dir
    cfg["evaluation"]["time_list"] = CCS_TIME_LIST
    if filters is not None:
        cfg["solver"]["filter"]["filters"] = filters
    path = out_dir.rstrip("/") + ".yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run_ccs(device):
    """Phase 10: ``cli.main(["--config_file", ..., "--eval"])`` on a copy of
    ``configs/hot_plate1.yaml`` over a full-width CCS recording, EVT3
    (and HDF5 where ``h5py`` imports), then with ``filters: [BAF, HOT]``."""
    import importlib.util
    import logging
    import shutil

    import numpy as np
    import torch

    from event_based_bos_tpu_torch import cli, kernels, runtime
    from event_based_bos_tpu_torch.data import ccs
    from event_based_bos_tpu_torch.utils import read_flow_error_text

    t0 = time.perf_counter()
    native = runtime.available()
    print(f"ccs: native runtime {native} ({runtime.library_path()})")
    assert native, "the native runtime did not build"
    formats = ["evt3"] + (["hdf5"] if importlib.util.find_spec("h5py")
                          else [])
    roots, n_events = write_ccs_recording(CCS_DIR, formats)
    print(f"ccs: recording {H}x{W}, {n_events} events as {formats} "
          f"({time.perf_counter() - t0:.1f} s to write)")
    sources = []
    set_sequence = ccs.CcsDataLoader.set_sequence

    def recorded(self, *args, **kwargs):
        set_sequence(self, *args, **kwargs)
        sources.append(self.event_source)

    ccs.CcsDataLoader.set_sequence = recorded
    root_log = logging.getLogger()
    handlers, level = root_log.handlers[:], root_log.level
    runs = {}
    try:
        for tag, fmt, filters in (("evt3", "evt3", None),
                                  ("hdf5", "hdf5", None),
                                  ("evt3_baf_hot", "evt3", ["BAF", "HOT"])):
            if fmt not in roots:
                continue
            out = os.path.join(CCS_DIR, "out_" + tag)
            shutil.rmtree(out, ignore_errors=True)
            path = hot_plate_copy(roots[fmt], out, filters)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t1 = time.perf_counter()
            rc = cli.main(["--config_file", path, "--eval", "--log",
                           "warning"], device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            votes = kernels.launches["hat_vote_image"]
            flows = sorted(n for n in os.listdir(out)
                           if n.startswith("pred_flow") and n.endswith(".npy"))
            epe = {}
            for name in SERVE_TEXTS:
                arrays, _stats = read_flow_error_text(os.path.join(out, name))
                assert np.isfinite(arrays["EPE"]).all(), (tag, name)
                epe[name] = [float(v) for v in arrays["EPE"]]
            for name in flows:
                check_flow(np.load(os.path.join(out, name)))
            runs[tag] = (out, flows)
            print(f"ccs: {tag}: rc {rc}, event route {sources[-1]}, "
                  f"{len(flows)} frames in {wall:.1f} s "
                  f"({1e3 * wall / max(len(flows), 1):.1f} ms/frame, the "
                  f"visualizing loop), vote launches {votes}, EPE without / "
                  f"with mask {epe[SERVE_TEXTS[0]]} / {epe[SERVE_TEXTS[1]]}")
            assert rc == 0 and sources[-1] == fmt, (rc, sources)
            assert len(flows) == 2, flows
            assert votes == 3 * len(flows),                 f"{votes} vote launches in {len(flows)} visualizing frames"
    finally:
        ccs.CcsDataLoader.set_sequence = set_sequence
        for h in root_log.handlers:
            if h not in handlers:
                h.close()
        root_log.handlers[:] = handlers
        root_log.setLevel(level)
    if "hdf5" in runs:
        same = all(np.array_equal(
            np.load(os.path.join(runs["evt3"][0], n)),
            np.load(os.path.join(runs["hdf5"][0], n)))
            for n in runs["evt3"][1])
        print(f"ccs: EVT3 flows bit-identical to HDF5 flows {same}")
        assert same, "the EVT3 and HDF5 runs differ"
    else:
        print("ccs: h5py is not installed: EVT3 only")
    print(f"ccs: phase {time.perf_counter() - t0:.1f} s")
    return {"votes": sum(3 * len(f) for _o, f in runs.values())}


OTHER_DU = (1.5, -0.8)     # phase 11's uniform pattern displacement (row, col)
OTHER_TRIALS = 512         # the samplers' budget at full width
GML_BOX = 3.0              # the samplers' box (−3, 3)² of (v_x, v_y)
CMAX_BOX = 4.0             # CMax translation's box (−4, 4)² around the dots
# PatchEklt's mean direction at 0.57 events/px on 4×4 patches: many
# patches hold a few events and each fits its own angle, so the cosine is
# about 0.6 here, the JAX package's solve's as well (its test's 0.7 is at
# 3.3 events/px on 32-px patches)
PATCH_COS_LIMIT = 0.5


def other_solvers_scene(h=None, w=None, n=None, du=OTHER_DU, seed=0):
    """A uniform-displacement scene (``tests/reference_harness.py::
    synthetic_scene``, rebuilt here): a smooth random pattern ``I1``, the
    pattern shifted by ``du``, and ``n`` events on integer sensor
    coordinates drawn where the brightness changes, signed by the change
    (by default ``H``×``W`` and ``CAPACITY − 1024`` events).  Returns
    ``(I1, events (n, 4))``."""
    import numpy as np

    h, w = h or H, w or W
    n = n or CAPACITY - 1024
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 3 + 2, w // 3 + 2))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    i1 = ((1 - fy) * (1 - fx) * coarse[np.ix_(y0, x0)]
          + fy * (1 - fx) * coarse[np.ix_(y0 + 1, x0)]
          + (1 - fy) * fx * coarse[np.ix_(y0, x0 + 1)]
          + fy * fx * coarse[np.ix_(y0 + 1, x0 + 1)])
    gy, gx = np.mgrid[0:h, 0:w].astype(float)
    sy = np.clip(gy - du[0], 0, h - 1)
    sx = np.clip(gx - du[1], 0, w - 1)
    yy0, xx0 = np.floor(sy).astype(int), np.floor(sx).astype(int)
    yy1, xx1 = np.minimum(yy0 + 1, h - 1), np.minimum(xx0 + 1, w - 1)
    fy2, fx2 = sy - yy0, sx - xx0
    i2 = ((1 - fy2) * (1 - fx2) * i1[yy0, xx0] + fy2 * (1 - fx2) * i1[yy1, xx0]
          + (1 - fy2) * fx2 * i1[yy0, xx1] + fy2 * fx2 * i1[yy1, xx1])
    dl = i2 - i1
    mag = np.abs(dl)
    idx = rng.choice(h * w, size=n, p=(mag / mag.sum()).reshape(-1))
    pol = np.sign(dl.reshape(-1)[idx])
    pol[pol == 0] = 1
    t = np.sort(rng.uniform(0, 0.008, n))
    events = np.stack([(idx // w).astype(float), (idx % w).astype(float), t,
                       pol], 1)
    return i1, events


def gml_spec(method, n_iter, size=None, roi=None, dtype=None, **kw):
    """The whole-ROI solver of ``tests/test_solvers.py``'s GML cases: the
    plain model with the warp pair (4 parameters; ``diff_norm`` and
    ``flow_norm_pxy``), lr 0.05; a sampler fits (v_x, v_y) alone in the
    box (−3, 3)²."""
    import torch

    from event_based_bos_tpu_torch.solver import GenerativeSpec, GmlSpec

    sampler = method in ("random", "grid")
    gen = GenerativeSpec(
        image_size=size or (H, W), iwe_sigma=2.0, weight_by_inverse_event_hist=False,
        optimize_warp=not sampler, poisson_model=False,
        cost_weights=((("diff_norm", 1.0),) if sampler else
                      (("diff_norm", 1.0), ("flow_norm_pxy", 0.1))),
        dtype=dtype or torch.float32)
    bounds = ((-GML_BOX, GML_BOX),) * 2 if sampler else ()
    return GmlSpec(gen=gen, roi=roi or ROI, method=method, n_iter=n_iter,
                   lr=0.05, param_bounds=bounds, **kw)


def other_solver_config(solver, n_iter=None, **optimizer):
    """A solver section (as a user's YAML gives it) for the tiled facades
    and GML's TPE (``solver`` the method name; ``optimizer`` overrides
    keys of the optimizer section): the patch sizes and cost weights as
    shipped, the angle model for ``patch_eklt``, the poisson model for
    ``patch_eklt_dependent``, (v_x, v_y) in (−3, 3)² for GML."""
    gml = solver == "generative_max_likelihood"
    box = {"min": -GML_BOX, "max": GML_BOX}
    return {
        "filter": {"filters": None, "parameters": dict(zip(
            ("xmin", "xmax", "ymin", "ymax"), ROI))},
        "method": solver,
        "cost_with_weight": ({"diff_norm": 1.0} if gml else
                             {"diff_norm": 1.0, "image_gradient": 0.5,
                              "flow_norm_pxy": 0.1}),
        "optimizer": {"method": "Adam", "n_iter": n_iter or N_ITER,
                      "parameters": {"v_x": box, "v_y": box}, **optimizer},
        "generative_ml": {"weight_loss_by_inverse_event_hist": True,
                          "optimize_warp": not gml, "iwe_sigma": 2,
                          "angle_model": solver == "patch_eklt",
                          "poisson_model": solver == "patch_eklt_dependent"},
        "patch_eklt": {"patch_size": 4, "sliding_window": 2},
    }


def direction_cosine(flow, roi=None):
    """Cosine of the mean flow over the ROI with −du (the generative model
    fits −du, the reference's convention)."""
    import numpy as np

    x0, x1, y0, y1 = roi or ROI
    v = np.asarray(flow)[:, x0:x1, y0:y1].reshape(2, -1).mean(1)
    du = -np.asarray(OTHER_DU)
    return float(v @ du / (np.linalg.norm(v) * np.linalg.norm(du) + 1e-12))


def timed_solve(solve):
    """``solve()`` with the launch counts set to 0 just before, a CUDA-event
    span around it and the host synchronisations it made counted
    (``torch.cuda.set_sync_debug_mode``); returns ``(out, ms, vote
    launches, host syncs)``."""
    import torch

    from event_based_bos_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            s.record()
            out = solve()
            e.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    e.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return out, s.elapsed_time(e), kernels.launches["hat_vote_image"], syncs


def repeated_solve(name, solve, frames=3):
    """A warm-up frame, then ``frames − 1`` timed frames of ``solve()``
    (each ``(flow, aux)``), which must be the same bit for bit; one vote
    launch a frame.  Returns the last ``(flow, aux)`` and the ms/frame."""
    import torch

    ms, flows, votes = [], [], []
    for _ in range(frames):
        (flow, aux), t, v, _syncs = timed_solve(solve)
        ms.append(t)
        flows.append(flow)
        votes.append(v)
    same = all(torch.equal(f, flows[1]) for f in flows[2:])
    timed = statistics.median(ms[1:])
    print(f"other solvers: {name}: {timed:.1f} ms/frame (frames "
          f"{', '.join(f'{t:.1f}' for t in ms)}, the first a warm-up); vote "
          f"launches a frame {votes}; timed frames bit-identical {same}")
    assert votes == [1] * frames, votes
    assert same, f"{name}: the timed frames differ"
    return flow, aux, timed


def check_small_other_solvers(device):
    """Phase 11: small float64 scenes of every new solver on the card and on
    the CPU must agree within 1e-6."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import events_from_ndarray
    from event_based_bos_tpu_torch.solver import (
        GenerativeSpec, PatchSpec, estimate_frame_dependent,
        estimate_frame_gml, estimate_frame_patch)

    h, w = 64, 96
    roi = (0, h, 16, 80)
    frame, evn = other_solvers_scene(h, w, 20000)
    x0 = np.array([0.1, -0.1, 0.0, 0.0])
    init = np.zeros((3, 31, 47))
    init[0] = np.random.default_rng(0).uniform(-1, 1, (31, 47))
    cases = {}
    for method, n_iter in (("Adam", 40), ("BFGS", 10), ("Nelder-Mead", 50),
                           ("Newton-CG", 5)):
        spec = gml_spec(method, n_iter, (h, w), roi, torch.float64)
        cases[f"GML {method} {n_iter}"] = (
            lambda ev, dev, spec=spec: estimate_frame_gml(
                ev, frame, None, spec, x0=x0, device=dev)[0])
    for dependent in (False, True):
        gen = GenerativeSpec(image_size=(h, w), iwe_sigma=2.0,
                             weight_by_inverse_event_hist=True,
                             angle_model=not dependent,
                             poisson_model=dependent, dtype=torch.float64)
        spec = PatchSpec(gen=gen, roi=roi, n_iter=40)
        if dependent:
            cases["PatchEkltDependent 40"] = (
                lambda ev, dev, spec=spec: estimate_frame_dependent(
                    ev, frame, None, spec, init_params=init, device=dev)[0])
        else:
            cases["PatchEklt 40"] = (
                lambda ev, dev, spec=spec: estimate_frame_patch(
                    ev, frame, None, spec, device=dev)[0])
    errs = {}
    for name, solve in cases.items():
        flows = [solve(events_from_ndarray(evn, dtype=torch.float64,
                                           device=dev), dev).cpu()
                 for dev in (device, "cpu")]
        assert torch.isfinite(flows[0]).all(), name
        errs[name] = float((flows[0] - flows[1]).abs().max())
    print("other solvers: small float64 scenes (64x96), card vs CPU max|flow "
          "diff| (limit 1e-6): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert max(errs.values()) <= 1e-6, errs


def run_other_solvers(device, loader, gt):
    """Phase 11: the other solvers at full width on a 720×1280
    uniform-displacement scene, CMax's translation model on the translating
    dots, and the GML serving loop."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import events_from_ndarray, kernels
    from event_based_bos_tpu_torch.solver import (
        estimate_frame_cmax, estimate_frame_dependent, estimate_frame_gml,
        estimate_frame_patch, facades, generative, programs)
    from event_based_bos_tpu_torch.solver.cmax import CmaxSpec

    t_phase = time.perf_counter()
    dev = torch.device(device)
    frame, evn = other_solvers_scene()
    ev = events_from_ndarray(evn, capacity=CAPACITY, device=dev)
    frame_t = torch.as_tensor(frame, dtype=torch.float32, device=dev)
    print(f"other solvers: scene {H}x{W}, {len(evn)} events, du "
          f"{OTHER_DU} ({time.perf_counter() - t_phase:.1f} s to make)")
    results, votes = {}, 0

    # GML, Adam: a warm-up and two timed frames.  Every iterative method
    # starts off 0: at v = 0 the prediction is 0, and at this event density
    # no fitted direction's loss beats that of the zero prediction, so the
    # best iterate would stay at the start
    x0 = torch.tensor([0.1, -0.1, 0.0, 0.0], device=dev)
    spec = gml_spec("Adam", N_ITER)
    flow, aux, ms = repeated_solve(
        f"GML Adam {N_ITER}", lambda: estimate_frame_gml(
            ev, frame_t, None, spec, x0=x0, device=dev))
    cos = direction_cosine(flow.cpu().numpy())
    print(f"other solvers: GML Adam: theta {aux['theta'].tolist()}, cosine "
          f"with -du {cos:.4f} (limit 0.9)")
    assert cos > 0.9, cos
    results["gml_adam"] = dict(ms_per_frame=ms, cosine=cos)
    votes += 3

    # GML, the other families: one frame each
    for method, n_iter in (("BFGS", 40), ("Nelder-Mead", 200),
                           ("Newton-CG", 20), ("random", OTHER_TRIALS),
                           ("grid", OTHER_TRIALS)):
        spec = gml_spec(method, n_iter)
        sampler = method in ("random", "grid")
        (flow, aux), ms, v, syncs = timed_solve(
            lambda: estimate_frame_gml(
                ev, frame_t, torch.Generator(dev).manual_seed(0), spec,
                x0=None if sampler else x0, device=dev))
        hist = aux["history"].cpu().numpy()
        flow_np = flow.cpu().numpy()
        cos = direction_cosine(flow_np)
        reads = aux.get("host_reads", 0)
        print(f"other solvers: GML {method} {n_iter}: {ms:.1f} ms, "
              f"{len(hist)} losses {hist[0]:.6g} -> best "
              f"{float(aux['loss']):.6g}, cosine with -du {cos:.4f}, vote "
              f"launches {v}, host reads {reads}, CUDA syncs {syncs}")
        assert np.isfinite(flow_np).all() and v == 1, (method, v)
        assert float(aux["loss"]) < hist[0], (method, hist[0])
        results[f"gml_{method}"] = dict(ms_per_frame=ms, cosine=cos,
                                        host_reads=reads, cuda_syncs=syncs)
        votes += 1

    # GML TPE through the facade (100 trials; the study on the host)
    solver_config = other_solver_config("generative_max_likelihood",
                                        n_iter=100, method="optuna",
                                        sampler="TPE")
    solv = facades.collections["generative_max_likelihood"](
        (H, W), (H, W), solver_config=solver_config, device=dev)
    handle, ms, v, syncs = timed_solve(
        lambda: (lambda hd: (hd.result(), hd))(
            solv.estimate_async(ev, frame=frame)))
    flow_np, hd = handle
    hist = hd.loss_history[0].cpu().numpy()
    cos = direction_cosine(flow_np)
    print(f"other solvers: GML TPE 100 (facade): {ms:.1f} ms, losses "
          f"{hist[0]:.6g} -> best {hist.min():.6g}, cosine with -du "
          f"{cos:.4f}, vote launches {v}, host reads {hd.host_reads} (the "
          f"seed and one a trial), CUDA syncs {syncs} (each trial's "
          f"upload too)")
    assert np.isfinite(flow_np).all() and v == 1 and hist.min() < hist[0]
    assert hd.host_reads == 101, hd.host_reads
    results["gml_TPE"] = dict(ms_per_frame=ms, cosine=cos,
                              host_reads=hd.host_reads, cuda_syncs=syncs)
    votes += 1

    # PatchEklt at the facade's defaults: 4/2 patches, the angle model
    solv = facades.collections["patch_eklt"](
        (H, W), (H, W), solver_config=other_solver_config("patch_eklt"),
        device=dev)
    pspec = solv.spec
    flow, aux, ms = repeated_solve(
        f"PatchEklt Adam {pspec.n_iter}, {pspec.grid.n_patch} patches "
        f"({pspec.grid.shape[0]}x{pspec.grid.shape[1]})",
        lambda: estimate_frame_patch(ev, frame_t, None, pspec, device=dev))
    cos = direction_cosine(flow.cpu().numpy())
    print(f"other solvers: PatchEklt: lr {pspec.lr}, mean direction's cosine "
          f"with -du {cos:.4f} (limit {PATCH_COS_LIMIT})")
    assert pspec.grid.shape == ((H - 4) // 2 + 1, (W - 4) // 2 + 1)
    assert pspec.lr == 0.01
    assert torch.isfinite(flow).all() and cos > PATCH_COS_LIMIT, cos
    results["patch_eklt"] = dict(ms_per_frame=ms, cosine=cos,
                                 patches=pspec.grid.n_patch)
    votes += 3

    # PatchEkltDependent at the same grid, the poisson model
    solv = facades.collections["patch_eklt_dependent"](
        (H, W), (H, W),
        solver_config=other_solver_config("patch_eklt_dependent"),
        device=dev)
    dspec = solv.spec
    flow, aux, ms = repeated_solve(
        f"PatchEkltDependent Adam {dspec.n_iter}",
        lambda: estimate_frame_dependent(
            ev, frame_t, torch.Generator(dev).manual_seed(0), dspec,
            device=dev))
    hist = aux["history"].cpu().numpy()
    cos = direction_cosine(flow.cpu().numpy())
    print(f"other solvers: PatchEkltDependent: losses {hist[0]:.6g} -> "
          f"best {float(aux['loss']):.6g}; mean direction's cosine with -du "
          f"{cos:.4f} (no limit)")
    assert torch.isfinite(flow).all() and float(aux["loss"]) < hist[0]
    results["patch_eklt_dependent"] = dict(ms_per_frame=ms, cosine=cos)
    votes += 3

    # CMax's translation model on the translating dots
    vx, vy = DOT_MOTION
    dots = moving_dot_events(H, W, vx, vy, CAPACITY - 1024, seed=1)
    dots[:, :2] = np.round(dots[:, :2])
    dev_dots = events_from_ndarray(dots, capacity=CAPACITY, device=dev)
    for method, n_iter in (("random", OTHER_TRIALS), ("BFGS", 40)):
        cspec = CmaxSpec(image_size=(H, W), roi=ROI,
                         motion_model="2d-translation", n_iter=n_iter,
                         method=method,
                         param_bounds=((-CMAX_BOX, CMAX_BOX),) * 2)
        (flow, aux), ms, v, syncs = timed_solve(
            lambda: estimate_frame_cmax(
                dev_dots, None, torch.Generator(dev).manual_seed(0), cspec,
                device=dev))
        got = flow[:, 0, 0].cpu().numpy()
        err = float(np.abs(got - [vx, vy]).max())
        reads = aux.get("host_reads", 0)
        print(f"other solvers: CMax translation {method} {n_iter} "
              f"({cspec.time_bins} bins): {ms:.1f} ms, flow "
              f"{got.tolist()} (dots {vx:g}, {vy:g}; off by {err:.3f} px, "
              f"limit 0.5), vote launches {v}, host reads {reads}, CUDA "
              f"syncs {syncs}")
        assert v == 1 and err < 0.5, (method, got)
        results[f"cmax_{method}"] = dict(ms_per_frame=ms, error_px=err,
                                         host_reads=reads, cuda_syncs=syncs)
        votes += 1

    # the serving loop: configs/hot_plate1.yaml's solver section with
    # method: generative_max_likelihood (the poisson model with the warp
    # pair: 3 parameters, the clamped read)
    config = serving_config("gml", method="generative_max_likelihood",
                            time_list=((0.01, 0.15),))
    solv, launches, callers, first, ms, lines = drive_serving(
        config, loader, device, gt,
        callers={"iwe_cache": (generative, "iwe_cache"),
                 "eventmask": (programs, "eventmask")})
    n = solv.iter_cnt
    per_caller = callers.launches()
    epe = check_serving_outputs(config, 2, zero_outside=False)
    flows = [np.load(os.path.join(config["output_dir"], f"pred_flow{i}.npy"))
             for i in range(n)]
    gen = torch.Generator(dev)
    gen.set_state(first["state"])
    direct, _ = estimate_frame_gml(first["events"], first["frame"], gen,
                                   solv.spec, device=dev)
    same = np.array_equal(first["handle"].result(),
                          solv._orient_flow(direct.cpu().numpy()))
    print(f"other solvers: serving GML (hot_plate1 solver, 3 parameters): "
          f"{n} frames, {ms:.1f} ms/frame (wall clock); vote launches "
          f"{launches['hat_vote_image']} ({per_caller}); EPE without mask "
          f"{epe[SERVE_TEXTS[0]]}; first frame bit-identical to "
          f"estimate_frame_gml {same}")
    assert n == 2 and solv.spec.gen.param_dim == 3, (n, solv.spec)
    assert per_caller == {"iwe_cache": 2, "eventmask": 2}, per_caller
    assert launches["hat_vote_image"] == 4, launches
    # one constant flow over the frame (no ROI mask in this solver)
    assert all(np.ptp(f[i]) == 0 for f in flows for i in (0, 1))
    assert same, "the facade's flow differs from estimate_frame_gml's"
    results["serving_gml"] = dict(ms_per_frame=ms, epe=epe,
                                  vote_launches=per_caller)
    votes += 4
    kernels.reset_launches()

    check_small_other_solvers(device)
    seconds = time.perf_counter() - t_phase
    print(f"other solvers: phase {seconds:.1f} s")
    print(json.dumps({"other_solvers": results}))
    return {"votes": votes, "results": results, "seconds": seconds}


PIV_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_piv")
E2VID_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_e2vid")
PIV_SHIFT = (2.3, -1.7)      # phase 12's particle displacement (row, col) px
PIV_LIMIT = 0.1              # px, mean error a component over the interior
#: the event-grid PIV's section (no shipped config has one)
PIV_EVENTS = {"integration_time": 0.01, "frame_distance": 0.01,
              "do_inversion": True}


def hot_plate_section(*keys):
    """A section of ``configs/hot_plate1.yaml`` (``keys`` down the tree)."""
    import yaml

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, "configs", "hot_plate1.yaml")) as f:
        section = yaml.safe_load(f)
    for key in keys:
        section = section[key]
    return section


def loader_windows(loader, frames=(1, 2, 3)):
    """The loader's events between frame ``i`` and ``i + 1`` for each
    ``i`` (consecutive windows), ``(n, 4)`` float64."""
    out = []
    for i in frames:
        _im, t1 = loader.load_image(i)
        _im, t2 = loader.load_image(i + 1)
        out.append(loader.load_event(max(loader.time_to_index(t1), 0),
                                     min(loader.time_to_index(t2),
                                         len(loader))))
    return out


def device_ms(fn, warmup=False):
    """One call of ``fn`` between two synchronisations (after one untimed
    call with ``warmup``): its result and its CUDA-event time in ms (the
    host's work inside it included)."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_device_baf(device, windows, params):
    """The exact device BAF over three consecutive windows with the time
    map carried: a float64 record bit-identical to the native runtime
    (keep masks and maps), a float32 record whose decisions differ from
    the float64 ones only where ``t − last`` lies within 4 float32 ulps of
    the timestamps of ``BAF_dt`` (the float64 filter's decision flips
    between ``BAF_dt ∓ 4 ulp``).  Returns the times."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import runtime
    from event_based_bos_tpu_torch.ops import filters
    from event_based_bos_tpu_torch.types import (bucket_capacity,
                                                 events_from_ndarray)

    dt, k, s = (params["BAF_dt"], params["BAF_ksize"],
                params["BAF_num_support_event"])
    ulp = float(np.spacing(np.float32(max(np.abs(w[:, 2]).max()
                                          for w in windows))))
    tol = 4 * ulp
    maps = {"native": None, "f64": None, "f32": None}
    rows = []
    for i, arr in enumerate(windows):
        n = len(arr)
        cap = bucket_capacity(n)
        ev64 = events_from_ndarray(arr, capacity=cap, dtype=torch.float64,
                                   device=device)
        ev32 = events_from_ndarray(arr, capacity=cap, device=device)
        prev64 = maps["f64"]
        t0 = time.perf_counter()
        nkeep, maps["native"] = runtime.baf_filter(
            arr, (H, W), dt, k, s, time_map=maps["native"])
        native_ms = 1e3 * (time.perf_counter() - t0)
        (out64, maps["f64"]), ms64 = device_ms(
            lambda: filters.background_activity_filter(
                ev64, (H, W), dt, k, s, time_map=prev64))
        prev32 = maps["f32"]
        (out32, maps["f32"]), ms32 = device_ms(
            lambda: filters.background_activity_filter(
                ev32, (H, W), dt, k, s, time_map=prev32))
        keep64 = out64.valid.cpu().numpy()[:n]
        same_keep = np.array_equal(keep64, nkeep)
        same_map = np.array_equal(maps["f64"].cpu().numpy(), maps["native"])
        lo, _ = filters.background_activity_filter(ev64, (H, W), dt - tol, k,
                                                   s, time_map=prev64)
        hi, _ = filters.background_activity_filter(ev64, (H, W), dt + tol, k,
                                                   s, time_map=prev64)
        keep32 = out32.valid.cpu().numpy()[:n]
        differ = keep32 != keep64
        boundary = (lo.valid != hi.valid).cpu().numpy()[:n]
        rows.append(dict(window=i, events=n, kept=int(nkeep.sum()),
                         native_ms=native_ms, device_f64_ms=ms64,
                         device_f32_ms=ms32,
                         f32_differing=int(differ.sum()),
                         f32_within_4ulp=int(boundary.sum())))
        print(f"baf: window {i}: {n} events, kept {int(nkeep.sum())}; "
              f"float64 keep/map bit-identical to the native runtime "
              f"{same_keep}/{same_map}; float32 decisions differing "
              f"{int(differ.sum())} (events within 4 ulp = {tol:.3e} s of "
              f"BAF_dt: {int(boundary.sum())}); device {ms64:.2f} ms "
              f"(float64), {ms32:.2f} ms (float32), native host "
              f"{native_ms:.2f} ms")
        assert same_keep and same_map, "the device BAF differs from native"
        assert not (differ & ~boundary).any(), \
            "a float32 BAF decision differs away from BAF_dt"
    return rows


def check_filters(device, windows, params):
    """Phase 12's filters: the exact BAF (:func:`check_device_baf`), the
    fast BAF and the flicker split card vs the port's CPU route bit for
    bit, HOT (a hot pixel injected) bit-identical to the native runtime
    at one vote launch a call.  Returns ``(results, HOT launches)``."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import kernels, runtime
    from event_based_bos_tpu_torch.ops import filters
    from event_based_bos_tpu_torch.types import (bucket_capacity,
                                                 events_from_ndarray)

    results = {"baf": check_device_baf(device, windows, params)}
    arr = windows[0].copy()
    arr[:400, :2] = (H // 3, W // 3)  # a hot pixel
    cap = bucket_capacity(len(arr))
    dev = events_from_ndarray(arr, capacity=cap, device=device)
    cpu = events_from_ndarray(arr, capacity=cap, device="cpu")
    fast, fast_ms = device_ms(lambda: filters.background_activity_filter_fast(
        dev, (H, W), params["BAF_dt"], params["BAF_ksize"],
        params["BAF_num_support_event"]), warmup=True)
    fast_cpu = filters.background_activity_filter_fast(
        cpu, (H, W), params["BAF_dt"], params["BAF_ksize"],
        params["BAF_num_support_event"])
    same_fast = torch.equal(fast.valid.cpu(), fast_cpu.valid)
    (linked, _unlinked), flicker_ms = device_ms(
        lambda: filters.flicker_filter(dev, 0.01), warmup=True)
    linked_cpu, _ = filters.flicker_filter(cpu, 0.01)
    same_flicker = torch.equal(linked.valid.cpu(), linked_cpu.valid)
    filters.hot_pixel_filter(dev, (H, W), params["HOT_thresh"])  # warm-up
    kernels.reset_launches()
    hot, hot_ms = device_ms(lambda: filters.hot_pixel_filter(
        dev, (H, W), params["HOT_thresh"]))
    hot_launches = kernels.launches["hat_vote_image"]
    keep = runtime.hot_pixel_filter(arr, (H, W), params["HOT_thresh"])
    same_hot = np.array_equal(hot.valid.cpu().numpy()[:len(arr)], keep)
    print(f"filters: fast BAF card vs CPU bit-identical {same_fast} "
          f"({int(fast.count())} kept, {fast_ms:.2f} ms); flicker "
          f"bit-identical {same_flicker} ({int(linked.count())} linked, "
          f"{flicker_ms:.2f} ms); HOT keep bit-identical to the native "
          f"runtime {same_hot} ({len(arr) - int(keep.sum())} dropped, "
          f"{hot_ms:.3f} ms, {hot_launches} vote launch)")
    assert same_fast and same_flicker and same_hot
    assert hot_launches == 1, hot_launches
    assert len(arr) - int(keep.sum()) >= 400
    results.update(fast_ms=fast_ms, flicker_ms=flicker_ms, hot_ms=hot_ms)
    return results, hot_launches


def check_preprocess(device, windows, params):
    """``solv.preprocess(Events)`` with ``filters: [BAF, HOT]`` on
    hot_plate1's solver section leaves the live events that
    ``preprocess(ndarray)`` leaves (two facades, the BAF map carried over
    the windows in each).  Returns the vote launches."""
    import copy

    import numpy as np
    import torch

    from event_based_bos_tpu_torch import kernels, solver
    from event_based_bos_tpu_torch.types import (bucket_capacity,
                                                 events_from_ndarray)
    from event_based_bos_tpu_torch.utils.config import propagate_config

    config = serving_config("preprocess")
    config["solver"]["filter"] = {"filters": ["BAF", "HOT"],
                                  "parameters": dict(params)}
    propagate_config(config)
    d = config["data"]
    solvers = [solver.collections[config["solver"]["method"]](
        (H, W), (d["crop_height"], d["crop_width"]),
        solver_config=copy.deepcopy(config["solver"]), device=device)
        for _ in range(2)]
    kernels.reset_launches()
    same = []
    for arr in windows:
        ev = events_from_ndarray(arr, capacity=bucket_capacity(len(arr)),
                                 dtype=torch.float64, device=device)
        dev, _ = solvers[0].preprocess(ev)
        host, _ = solvers[1].preprocess(arr)
        same.append(np.array_equal(dev.to_numpy().astype(np.float32),
                                   host.to_numpy()))
    votes = kernels.launches["hat_vote_image"]
    print(f"preprocess [BAF, HOT]: Events vs ndarray same live events "
          f"{same} over {len(windows)} windows, {votes} vote launches")
    assert all(same), "the device pipeline differs from the host pipeline"
    assert votes == len(windows), votes
    return votes


def render_particles(pos, shape, sigma=1.2):
    """The particle image of ``tests/test_ops_flow.py::TestPIVAccuracy``
    (every pixel within 5 px of a particle on each axis gets its
    Gaussian), scattered particle by particle's 10×10 neighbourhood."""
    import numpy as np

    img = np.zeros(shape)
    offs = np.arange(-5, 6)
    r0 = np.floor(pos[:, 0]).astype(int)
    c0 = np.floor(pos[:, 1]).astype(int)
    for dr in offs:
        for dc in offs:
            rr, cc = r0 + dr, c0 + dc
            m = ((np.abs(rr - pos[:, 0]) < 5) & (np.abs(cc - pos[:, 1]) < 5)
                 & (rr >= 0) & (rr < shape[0]) & (cc >= 0) & (cc < shape[1]))
            v = np.exp(-((rr - pos[:, 0]) ** 2 + (cc - pos[:, 1]) ** 2)
                       / (2 * sigma ** 2))
            np.add.at(img, (rr[m], cc[m]), v[m])
    return 255.0 * img / max(img.max(), 1e-9)


def particle_pair(shape, shift, density=900 / (128 * 160), seed=3):
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(density * shape[0] * shape[1])
    pos = np.stack([rng.uniform(4, shape[0] - 4, n),
                    rng.uniform(4, shape[1] - 4, n)], 1)
    return (render_particles(pos, shape),
            render_particles(pos + np.asarray(shift), shape))


def check_piv(device):
    """The PIV at full width with hot_plate1's ``params_openpiv`` (64→8
    over the 720×640 ROI) on a particle pair moved by ``PIV_SHIFT``: mean
    error a component over the ROI interior (32 px in) below
    ``PIV_LIMIT``; a small float64 scene card vs CPU within 1e-9."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import piv
    from event_based_bos_tpu_torch.utils.config import (PivSettings,
                                                        load_config_openpiv)

    roi = dict(zip(("xmin", "xmax", "ymin", "ymax"), ROI))
    settings = load_config_openpiv(hot_plate_section("params_openpiv"), roi,
                                   ".")
    t0 = time.perf_counter()
    a, b = particle_pair((H, W), PIV_SHIFT)
    print(f"piv: particle pair {H}x{W} ({time.perf_counter() - t0:.1f} s "
          f"to render), windows {settings.windowsizes}, overlap "
          f"{settings.overlap}, ROI {settings.roi}")
    piv.piv_multipass(a, b, settings, device=device)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow = piv.piv_multipass(a, b, settings, device=device)
    ms = 1e3 * (time.perf_counter() - t0)
    x0, x1, y0, y1 = ROI
    inner = (slice(x0 + 32, x1 - 32), slice(y0 + 32, y1 - 32))
    err_r = float(np.abs(flow[1][inner] - PIV_SHIFT[0]).mean())
    err_c = float(np.abs(flow[0][inner] - PIV_SHIFT[1]).mean())
    sa, sb = particle_pair((128, 160), (1.3, -0.6), seed=5)
    small = PivSettings(windowsizes=(64, 32, 16), overlap=(32, 16, 8))
    card = piv.piv_multipass(sa, sb, small, device=device,
                             dtype=torch.float64)
    cpu = piv.piv_multipass(sa, sb, small, device="cpu", dtype=torch.float64)
    small_err = float(np.abs(card - cpu).max())
    print(f"piv: {ms:.1f} ms a pair (host clock, one upload and one fetch); "
          f"mean error over the ROI interior row {err_r:.4f} px, col "
          f"{err_c:.4f} px (limit {PIV_LIMIT}); small float64 scene card vs "
          f"CPU max|diff| {small_err:.3e}")
    assert flow.shape == (2, H, W) and np.isfinite(flow).all()
    assert err_r < PIV_LIMIT and err_c < PIV_LIMIT, (err_r, err_c)
    assert small_err <= 1e-9, small_err
    return dict(ms=ms, err_row=err_r, err_col=err_c, small_err=small_err)


def piv_config(name, **top):
    """Phase 6's config with hot_plate1's ``params_openpiv``, the
    event-grid section, visualizing, in its own directory under
    ``PIV_DIR``."""
    from event_based_bos_tpu_torch.utils.config import propagate_config

    config = serving_config(name)
    config.update(output_dir=os.path.join(PIV_DIR, name), visualize=True,
                  params_openpiv=hot_plate_section("params_openpiv"),
                  params_openpiv_events=dict(PIV_EVENTS))
    config.update(top)
    propagate_config(config)
    return config


def run_event_grid_piv(device):
    """``cli.main([..., "--eval"])`` with ``estimation_method: openpiv`` on
    the SYNTHETIC loader at full width: two vote launches a pair, each
    histogram bit-identical to the plain vote, every flow and histogram
    PNG decoding at H×W.  Returns ``(launches, ms a pair)``."""
    import glob
    import logging
    import shutil

    import torch
    import yaml

    from event_based_bos_tpu_torch import cli, kernels
    from event_based_bos_tpu_torch.ops import iwe, iwe_cuda

    config = piv_config("event_grids", estimation_method="openpiv")
    config["evaluation"]["time_list"] = [[0.01, 0.15]]
    out = config["output_dir"]
    shutil.rmtree(out, ignore_errors=True)
    path = out + ".yaml"
    os.makedirs(PIV_DIR, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    hists = []
    vote = iwe.create_image_from_events

    def checked(ev, *args, **kwargs):
        image = vote(ev, *args, **kwargs)
        plain = iwe_cuda.hat_vote_plain(
            ev.x.to(torch.float32), ev.y.to(torch.float32), None, (H, W),
            valid=ev.valid, nudge=True)
        hists.append(torch.equal(image, plain))
        return image

    iwe.create_image_from_events = checked
    root_log = logging.getLogger()
    handlers, level = root_log.handlers[:], root_log.level
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["--config_file", path, "--eval", "--log", "warning"],
                      device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        votes = kernels.launches["hat_vote_image"]
    finally:
        iwe.create_image_from_events = vote
        for h in root_log.handlers:
            if h not in handlers:
                h.close()
        root_log.handlers[:] = handlers
        root_log.setLevel(level)
    pngs = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(out, "*.png")))
    pairs = sum(n.startswith("event_flow_openpiv") for n in pngs)
    checked_pngs = [n for n in pngs if n.startswith(("event_flow_openpiv",
                                                     "hist"))]
    check_pngs(out, checked_pngs)
    print(f"event-grid piv: rc {rc}, {pairs} pairs in {wall:.1f} s (with "
          f"the loader's generation), vote launches {votes}, histograms "
          f"bit-identical to the plain vote {hists}; PNGs {pngs}")
    assert rc == 0 and pairs >= 1, (rc, pngs)
    assert votes == 2 * pairs, (votes, pairs)
    assert len(hists) == 2 * pairs and all(hists), hists
    assert sum(n.startswith("hist") for n in pngs) == 2 * pairs, pngs
    return votes, 1e3 * wall / pairs


def run_piv_ground_truth(device, loader):
    """One ``--eval`` pyramid frame (60 iterations) with ``method:
    openpiv``: the PIV GT on the card, both error texts written."""
    import numpy as np

    from event_based_bos_tpu_torch.utils import read_flow_error_text

    config = piv_config("piv_gt", method="openpiv", visualize=False)
    config["evaluation"]["time_list"] = [[0.01, 0.11]]
    config["solver"]["optimizer"]["n_iter"] = 60
    solv, launches, _callers, _first, ms, _lines = drive_serving(
        config, loader, device, None)
    epe = {}
    for name in SERVE_TEXTS:
        arrays, stats = read_flow_error_text(
            os.path.join(config["output_dir"], name))
        assert stats["EPE"]["n_data"] == 1 and np.isfinite(
            arrays["EPE"]).all(), (name, arrays)
        epe[name] = float(arrays["EPE"][0])
    print(f"piv GT: 1 pyramid frame (60 iterations) with method: openpiv, "
          f"{ms:.1f} ms; EPE against the PIV GT {epe}; launches {launches}")
    assert solv.iter_cnt == 1
    return epe


def run_e2vid(device, loader):
    """``model_image: e2vid``: an E2VID sequence written under
    ``E2VID_DIR`` from the loader's frames (8-bit PNGs, their times, an
    events CSV), the pyramid (60 iterations) with ``generative_ml.e2vid``
    pointing at it, bit-identical to ``model_image: current`` fed the
    decoded PNG at the frame's time (the loader's image index)."""
    import copy
    import shutil

    import cv2
    import numpy as np

    from event_based_bos_tpu_torch import solver
    from event_based_bos_tpu_torch.data.e2vid import E2vidDataLoader

    seq = os.path.join(E2VID_DIR, "E2VID", "seq")
    shutil.rmtree(E2VID_DIR, ignore_errors=True)
    os.makedirs(seq)
    times = []
    for i in range(loader.num_images):
        image, t = loader.load_image(i)
        assert cv2.imwrite(os.path.join(seq, f"frame_{i:010d}.png"),
                           np.clip(image, 0, 255).astype(np.uint8))
        times.append(t)
    np.savetxt(os.path.join(seq, "timestamps.txt"), times)
    with open(os.path.join(seq, "events.csv"), "w") as f:
        for x, y, t, p in loader.load_event(0, 1000):
            f.write(f"{int(y)},{int(x)},{int(p > 0)},{t:.9f}\n")
    reader = E2vidDataLoader(config={"root": E2VID_DIR})
    reader.set_sequence("seq")
    flows = {}
    (arr,) = loader_windows(loader, (2,))
    _im, t2 = loader.load_image(2)
    for mode in ("e2vid", "current"):
        config = serving_config("e2vid_" + mode)
        gml = config["solver"]["generative_ml"]
        gml["model_image"] = mode
        if mode == "e2vid":
            gml["e2vid"] = {"root": E2VID_DIR, "dataset": "E2VID",
                            "sequence": "seq"}
        config["solver"]["optimizer"]["n_iter"] = 60
        d = config["data"]
        solv = solver.collections[config["solver"]["method"]](
            (H, W), (d["crop_height"], d["crop_width"]),
            solver_config=copy.deepcopy(config["solver"]), device=device)
        ev, _ = solv.preprocess(arr)
        if mode == "e2vid":
            frame = np.zeros((H, W))  # unused: the reconstruction wins
        else:
            frame, _t = reader.load_image(reader.time_to_image_index(t2))
        t0 = time.perf_counter()
        flows[mode] = solv.estimate(ev, frame=frame, frame_time=t2)
        ms = 1e3 * (time.perf_counter() - t0)
        print(f"e2vid: model_image {mode}: {ms:.1f} ms (60 iterations)")
    same = np.array_equal(flows["e2vid"], flows["current"])
    print(f"e2vid: {reader.num_images} reconstructions, image "
          f"{reader.time_to_image_index(t2)} at t = {t2:.4f} s; flow "
          f"bit-identical to model_image: current on the decoded PNG {same}")
    assert same and np.abs(flows["e2vid"]).max() > 0
    return same


def check_dense_ops(device, windows, loader):
    """Voxel grids, weighted images and flow propagation at full width,
    card vs CPU within 1e-5 relative (float32 atomics' order); device ms
    of each.  Returns the vote launches of the weighted images."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import kernels
    from event_based_bos_tpu_torch.ops import flow as tflow
    from event_based_bos_tpu_torch.ops import iwe, voxel
    from event_based_bos_tpu_torch.types import (bucket_capacity,
                                                 events_from_ndarray)

    arr = windows[0]
    cap = bucket_capacity(len(arr))
    evs = {d: events_from_ndarray(arr, capacity=cap, device=d)
           for d in (device, "cpu")}
    det_j = np.random.default_rng(0).uniform(0.8, 1.2, cap)
    weights = {d: torch.as_tensor(det_j, dtype=torch.float32, device=d)
               for d in evs}
    gt = {d: torch.as_tensor(loader.load_optical_flow(1),
                             dtype=torch.float32, device=d) for d in evs}
    cases = {
        "event_voxel_5": lambda d: voxel.create_event_voxel(evs[d],
                                                           (5, H, W)),
        "discretized_volume_10": lambda d:
            voxel.generate_discretized_event_volume(evs[d], (10, H, W)),
        "timeimage": lambda d: iwe.create_timeimage(evs[d], (H, W)),
        "iwa": lambda d: iwe.create_iwa(evs[d], (H, W), weights[d]),
    }
    for scheme in ("bilinear", "max", "upwind", "burgers"):
        cases[f"propagate_{scheme}_5"] = (
            lambda d, s=scheme: tflow.construct_dense_flow_voxel(gt[d], 5,
                                                                 s))
    results = {}
    votes = 0
    for name, fn in cases.items():
        fn(device)  # warm-up
        kernels.reset_launches()
        card, ms = device_ms(lambda: fn(device))
        votes += kernels.launches["hat_vote_image"]
        cpu = fn("cpu")
        rel = float((card.cpu() - cpu).abs().max()
                    / (cpu.abs().max() + 1e-30))
        results[name] = dict(ms=ms, rel_err=rel)
        print(f"dense ops: {name} {tuple(card.shape)}: {ms:.3f} ms, card vs "
              f"CPU relative max|diff| {rel:.3e}")
        assert rel <= 1e-5, (name, rel)
    assert votes == 3, votes  # the time image 1, IWA 2
    return results, votes


def run_remaining_ops(device, loader):
    """Phase 12: the filters, the PIV, the event-grid PIV and the PIV GT,
    ``model_image: e2vid`` and the voxel, weighted-image and propagation
    ops at full width."""
    t0 = time.perf_counter()
    params = hot_plate_section("solver", "filter", "parameters")
    windows = loader_windows(loader)
    print(f"phase 12: hot_plate1 filter parameters {params}; windows "
          f"{[len(w) for w in windows]} events")
    filt, hot_votes = check_filters(device, windows, params)
    pre_votes = check_preprocess(device, windows, params)
    piv_result = check_piv(device)
    grid_votes, grid_ms = run_event_grid_piv(device)
    gt_epe = run_piv_ground_truth(device, loader)
    run_e2vid(device, loader)
    dense, dense_votes = check_dense_ops(device, windows, loader)
    seconds = time.perf_counter() - t0
    card = card_line()
    baf = filt["baf"]
    print(f"phase 12 on {card}: device BAF "
          f"{statistics.median(r['device_f64_ms'] for r in baf):.2f} ms a "
          f"window (float64; float32 "
          f"{statistics.median(r['device_f32_ms'] for r in baf):.2f}) beside "
          f"the native host BAF "
          f"{statistics.median(r['native_ms'] for r in baf):.2f} ms; HOT "
          f"{filt['hot_ms']:.3f} ms; PIV {piv_result['ms']:.1f} ms a pair; "
          f"event-grid PIV {grid_ms:.1f} ms a pair (wall clock)")
    print(json.dumps({"remaining_ops": dict(
        card=card, filters=filt, piv=piv_result, event_grid_ms=grid_ms,
        piv_gt_epe=gt_epe, dense=dense, seconds=seconds)}))
    print(f"remaining ops: phase {seconds:.1f} s")
    return {"filters": hot_votes + pre_votes, "piv": grid_votes,
            "weighted_images": dense_votes}



# ---------------------------------------------------------------------------
# Phase 13: the wire and the mesh
# ---------------------------------------------------------------------------

MESH_ITERS = 60
MESH_INPUTS = os.path.join(SERVE_DIR, "mesh_inputs.npz")


def same_bits(a, b):
    """Two tensors of one dtype and shape with equal bytes (−0.0 and +0.0
    differ; so would two NaN payloads)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def within_f16_rounding(got, want):
    """``got`` within float16 rounding of ``want``: relative 2⁻¹¹ plus one
    float16 ulp at 0 (2⁻²⁴), with 2⁻⁹ of slack for the float32 rounding of
    the loop's time rescale on both sides."""
    import numpy as np

    err = np.abs(got.astype(np.float64) - want)
    return bool(np.all(err <= 2.0 ** -11 * (1 + 2.0 ** -9) * np.abs(want)
                       + 2.0 ** -24))


def median_ms(fn, reps=5):
    import statistics

    return statistics.median(device_ms(fn)[1] for _ in range(reps))


def check_uploads(device, window):
    """(a) the wire on one full window: the default upload equals the
    direct upload bit for bit, the ``quantized_upload: true`` t-less wire
    decodes x, y, p and valid bit for bit; bytes a window and ms of each
    route (CUDA events around upload + decode; the host encode apart)."""
    import numpy as np

    from event_based_bos_tpu_torch import solver
    from event_based_bos_tpu_torch.types import (
        bucket_capacity, decode_wire_events, encode_wire_events,
        events_from_ndarray, wire_nbytes)

    n, cap = len(window), bucket_capacity(len(window))
    config = serving_config("wire")
    solv = solver.collections["patch_eklt_pyramid2"](
        (H, W), (H, W), solver_config=config["solver"], device=device)
    direct = events_from_ndarray(window, capacity=cap, device=device)
    default = solv._to_events(window)
    default_same = all(same_bits(a, b) for a, b in zip(default, direct))
    wires = {include_t: encode_wire_events(window, cap, include_t=include_t)
             for include_t in (False, True)}
    tless = decode_wire_events(wires[False], device=device)
    tless_same = all(same_bits(getattr(tless, f), getattr(direct, f))
                     for f in ("x", "y", "p", "valid"))
    t0 = time.perf_counter()
    for _ in range(5):
        encode_wire_events(window, cap, include_t=False)
    encode_ms = 1e3 * (time.perf_counter() - t0) / 5
    out = {
        "events": n, "capacity": cap,
        "bytes_per_event": {"direct": 16.0,
                            "wire_tless": wire_nbytes(wires[False]) / n,
                            "wire_t": wire_nbytes(wires[True]) / n},
        "ms": {"direct": median_ms(lambda: events_from_ndarray(
                   window, capacity=cap, device=device)),
               "wire_tless": median_ms(lambda: decode_wire_events(
                   wires[False], device=device)),
               "wire_t": median_ms(lambda: decode_wire_events(
                   wires[True], device=device)),
               "encode_tless_host": encode_ms},
        "default_bit_identical": default_same,
        "tless_bit_identical": tless_same}
    print(f"wire: {n} events (capacity {cap}); bytes/event direct 16 "
          f"(4 float32 fields), t-less wire "
          f"{out['bytes_per_event']['wire_tless']:.4f}, with t "
          f"{out['bytes_per_event']['wire_t']:.4f}; upload ms (CUDA events) "
          f"direct {out['ms']['direct']:.3f}, t-less upload + decode "
          f"{out['ms']['wire_tless']:.3f}, with t "
          f"{out['ms']['wire_t']:.3f}; host encode {encode_ms:.3f} ms; "
          f"default upload bit-identical to direct {default_same}; t-less "
          f"x, y, p, valid bit-identical {tless_same}")
    assert default_same, "the default upload differs from the direct one"
    assert tless_same, "the t-less wire decodes other x, y, p or valid"
    return out


def error_texts(out_dir):
    from event_based_bos_tpu_torch.utils import read_flow_error_text

    return {name: read_flow_error_text(os.path.join(out_dir, name))[0]
            for name in SERVE_TEXTS}


def run_wire_serving(device, loader, gt):
    """(a) phase 6's 3-frame serving loop with ``quantized_upload: true``
    and ``flow_fetch_dtype: float16`` (phase 6's generator stream): every
    flow within float16 rounding of phase 6's float32 flow, the error
    texts within the JAX package's bound (2e-3 px, 0.05 for the nPE
    percentages), two vote launches a frame."""
    import numpy as np

    config = serving_config("wire_f16")
    config["solver"].update(quantized_upload=True,
                            flow_fetch_dtype="float16")
    solv, launches, callers, _first, ms, _lines = drive_serving(
        config, loader, device, gt)
    check_serving_outputs(config, 3)
    base = os.path.join(SERVE_DIR, "pyramid")
    close = [within_f16_rounding(
        np.load(os.path.join(config["output_dir"], f"pred_flow{i}.npy")),
        np.load(os.path.join(base, f"pred_flow{i}.npy"))) for i in range(3)]
    got, want = error_texts(config["output_dir"]), error_texts(base)
    worst = {}
    for name in SERVE_TEXTS:
        for key, values in want[name].items():
            tol = 0.05 if key.endswith("PE") and key != "EPE" else 2e-3
            dev = float(np.max(np.abs(np.asarray(got[name][key], float)
                                      - np.asarray(values, float))))
            worst[key] = max(worst.get(key, 0.0), dev)
            assert dev <= tol, (name, key, dev)
    print(f"wire serving (quantized_upload: true, flow_fetch_dtype: "
          f"float16): {solv.iter_cnt} frames, {ms:.1f} ms/frame (wall "
          f"clock); vote launches {launches['hat_vote_image']} "
          f"({callers.launches()}); flows within float16 rounding of phase "
          f"6's {close}; largest error-text deviation {worst}")
    assert solv.wire_quantized and not solv._wire_fell_back
    assert all(close), "a float16-fetched flow is off the rounding bound"
    assert launches["hat_vote_image"] == 6, launches
    return {"ms_per_frame": ms, "launches": launches["hat_vote_image"],
            "text_deviation": worst}


def run_mesh_cli(device):
    """(b) ``cli.main`` on phase 6's config with ``mesh: {data: 1, event:
    1}``: each frame's init drawn from the solver's generator before the
    step, the votes as polarity planes; ``pred_flow{i}.npy`` bit-identical
    to phase 6's."""
    import shutil

    import numpy as np
    import yaml

    from event_based_bos_tpu_torch import cli, kernels

    config = serving_config("mesh11")
    config["mesh"] = {"data": 1, "event": 1}
    shutil.rmtree(config["output_dir"], ignore_errors=True)
    path = config["output_dir"] + ".yaml"
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    sync(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    assert cli.main(["--config_file", path, "--eval"], device=device) == 0
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    kernels.reset_launches()
    base = os.path.join(SERVE_DIR, "pyramid")
    same = [np.load(os.path.join(config["output_dir"],
                                 f"pred_flow{i}.npy")).tobytes()
            == np.load(os.path.join(base, f"pred_flow{i}.npy")).tobytes()
            for i in range(3)]
    print(f"mesh 1x1 through cli.main: 3 frames in {wall:.1f} s (Farnebäck "
          f"GT and the loader's generation included); vote launches "
          f"{launches['hat_vote_image']} (a polarity-plane vote and the "
          f"event mask a frame); pred_flow bit-identical to phase 6's "
          f"{same}")
    assert all(same), "the 1x1 mesh loop's flows differ from phase 6's"
    assert launches["hat_vote_image"] == 6, launches
    return {"seconds": wall, "launches": launches["hat_vote_image"]}


def mesh_solver(device, n_iter=MESH_ITERS, **extra):
    """``configs/hot_plate1.yaml``'s pyramid at full width (phase 6's
    solver section) at ``n_iter`` iterations, on ``device``."""
    from event_based_bos_tpu_torch import solver

    config = serving_config("mesh4")
    config["solver"]["optimizer"]["n_iter"] = n_iter
    config["solver"].update(extra)
    return solver.collections["patch_eklt_pyramid2"](
        (H, W), (H, W), solver_config=config["solver"], device=device)


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_rank_phase(inputs_path, sizes):
    """(c) on each rank of a 2×2 mesh sharing the card: the batched step
    on 2 frames, the multi-start (R = 4 over data 2) and 2 sequential
    lanes × 3 steps at ``MESH_ITERS``; ms a step, the all-reduce of one
    frame's [2, H, W] float32 planes, vote launches of every rank.  Rank 0
    returns its results.  ``sizes`` are the parent's ``H``, ``W``, ``ROI``
    and ``CAPACITY`` (a rehearsal on the CPU shrinks them)."""
    globals().update(sizes)
    import dataclasses
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from event_based_bos_tpu_torch import kernels
    from event_based_bos_tpu_torch.parallel import (
        make_mesh, make_multichip_estimator, make_multichip_multistart,
        make_multichip_sequential, stack_events)
    from event_based_bos_tpu_torch.parallel.mesh import all_reduce_
    from event_based_bos_tpu_torch.types import (bucket_capacity,
                                                 events_from_ndarray)

    mesh = make_mesh((2, 2))
    dev = mesh.device
    if dev.type == "cuda":
        kernels.library()
    data = np.load(inputs_path)
    windows, frames = data["windows"], data["frames"]
    cap = bucket_capacity(windows.shape[1])
    evs = [events_from_ndarray(w, capacity=cap, device=dev) for w in windows]
    solv = mesh_solver(dev)
    solv4 = mesh_solver(dev, n_restarts=4)
    mask = solv._mask
    steady = dataclasses.replace(solv.spec, n_iter=MESH_ITERS // 2)

    def timed(fn):
        dist.barrier()
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    kernels.reset_launches()
    out = {"backend": mesh.backend, "shape": mesh.axis_shape,
           "votes_per_rank_events": cap // 2}
    step = make_multichip_estimator(solv.spec, mesh)
    (flows, hists), ms_batched = timed(lambda: step(
        stack_events(evs[:2]), frames[:2], mask, data["inits_batched"]))
    out["batched"] = (flows.cpu().numpy(), [h.cpu().numpy() for h in hists])
    multi = make_multichip_multistart(solv4.spec, mesh)
    (flow, hists), ms_multi = timed(lambda: multi(
        stack_events(evs[:1]), frames[:1], mask, data["inits_multistart"]))
    out["multistart"] = (flow.cpu().numpy(), [h.cpu().numpy() for h in hists])
    cold, warm = make_multichip_sequential(solv.spec, mesh,
                                           steady_spec=steady)
    prev, seq, ms_seq = None, [], []
    for t in range(3):
        lanes = [evs[t], evs[(t + 1) % 3]]
        fr = frames[[t, (t + 1) % 3]]
        if t == 0:
            (flows, prev, _), ms = timed(lambda: cold(
                stack_events(lanes), fr, mask, data["inits_sequential"]))
        else:
            (flows, prev, _), ms = timed(lambda: warm(
                stack_events(lanes), fr, mask, prev, [True, True]))
        seq.append(flows.cpu().numpy())
        ms_seq.append(ms)
    out["sequential"] = seq
    votes = torch.zeros(4, dtype=torch.float64)
    votes[mesh.rank] = kernels.launches["hat_vote_image"]
    dist.all_reduce(votes)
    out["votes"] = votes.tolist()
    planes = torch.ones((2, H, W), dtype=torch.float32, device=dev)
    spans = [timed(lambda: all_reduce_(planes, mesh, "event"))[1]
             for _ in range(5)]
    out["ms"] = {"batched_step": ms_batched, "multistart_step": ms_multi,
                 "sequential_steps": ms_seq,
                 "all_reduce_2x720x1280_f32": statistics.median(spans)}
    return out


def mesh_references(device, inputs):
    """The same solves in this process: the pyramid facade's route (the
    IWE cache's signed vote, then ``estimate_frame``) from the same
    inits."""
    import dataclasses

    import torch

    from event_based_bos_tpu_torch.ops.gradients import frame_gradients
    from event_based_bos_tpu_torch.solver.generative import iwe_cache
    from event_based_bos_tpu_torch.solver.pyramid import (
        estimate_frame, select_restart, solve_pyramid,
        update_coarse_from_fine)
    from event_based_bos_tpu_torch.types import (bucket_capacity,
                                                 events_from_ndarray)

    solv = mesh_solver(device)
    solv4 = mesh_solver(device, n_restarts=4)
    steady = dataclasses.replace(solv.spec, n_iter=MESH_ITERS // 2)
    windows, frames = inputs["windows"], inputs["frames"]
    cap = bucket_capacity(windows.shape[1])
    evs = [events_from_ndarray(w, capacity=cap, device=device)
           for w in windows]

    def solve(b, spec, init=None, prev=None):
        return estimate_frame(None, frames[b], solv._mask, None, spec,
                              prev_params=prev, init_params=init,
                              cache=iwe_cache(evs[b], spec.gen),
                              device=device)

    ref = {"batched": [solve(b, solv.spec, inputs["inits_batched"][b])
                       for b in range(2)]}
    hist, weights, wi = iwe_cache(evs[0], solv4.gen)
    frame = torch.as_tensor(frames[0]).to(device=device, dtype=torch.float32)
    gx, gy = frame_gradients(frame, ksize=solv4.gen.sobel_ksize,
                             use_log_intensity=solv4.gen.use_log_intensity)
    lanes = [solve_pyramid(hist, weights, wi, gx, gy, solv4._mask, None,
                           solv4.spec, init_params=torch.as_tensor(
                               x0, device=device))
             for x0 in inputs["inits_multistart"]]
    ref["multistart"] = select_restart(lanes, solv4.spec.track_best)
    chains = []
    for d in range(2):
        prev, flows = None, []
        for t in range(3):
            b = (t + d) % 3
            used = solv.spec if t == 0 else steady
            flow, aux = solve(b, used, inputs["inits_sequential"][d]
                              if prev is None else None, prev)
            prev = update_coarse_from_fine(aux["params_per_scale"], used)
            flows.append(flow)
        chains.append(flows)
    ref["sequential"] = chains
    return ref


def check_rank_vote(device, window):
    """Kernel #1 on a rank's share: the polarity-plane vote of half the
    capacity (the first event slice of a 2-rank event axis) against its
    plain version, bit for bit on integer coordinates."""
    import torch

    from event_based_bos_tpu_torch.ops import iwe_cuda
    from event_based_bos_tpu_torch.types import (Events, bucket_capacity,
                                                 events_from_ndarray)

    cap = bucket_capacity(len(window))
    ev = events_from_ndarray(window, capacity=cap, device=device)
    half = Events(*(f[:cap // 2] for f in ev))
    got = iwe_cuda.polarity_iwe_cuda(half, (H, W), nudge=True)
    plain = iwe_cuda.hat_vote_plain(
        half.x.to(torch.float32), half.y.to(torch.float32), None, (H, W),
        valid=half.valid, polarity_planes=half.p, nudge=True)
    err = float((got - plain).abs().max())
    print(f"mesh rank vote: {cap // 2} events into [2, {H}, {W}] polarity "
          f"planes, kernel vs plain max|diff| {err:.3e}, bit-identical "
          f"{same_bits(got, plain)}")
    assert same_bits(got, plain), "the rank's polarity vote differs"
    return err


def run_rank_mesh(device, loader):
    """(c) four ranks sharing the card (2×2 over gloo), each step against
    the same solves in this process, bit for bit."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch.parallel import launch
    from event_based_bos_tpu_torch.solver.generative import initialize_params
    from event_based_bos_tpu_torch.solver.pyramid import pyramid_grids

    windows = loader_windows(loader)
    counts = [len(w) for w in windows]
    assert len(set(counts)) == 1, counts
    solv = mesh_solver(device)
    gen = torch.Generator(device).manual_seed(0)
    shape = pyramid_grids(solv.spec)[0].shape

    def draw(k):
        return np.stack([initialize_params(gen, shape, solv.gen,
                                           device).cpu().numpy()
                         for _ in range(k)])

    frames = np.stack([loader.load_image(i)[0] for i in (1, 2, 3)])
    inputs = {"windows": np.stack(windows).astype(np.float64),
              "frames": frames.astype(np.float32),
              "inits_batched": draw(2), "inits_multistart": draw(4),
              "inits_sequential": draw(2)}
    np.savez(MESH_INPUTS, **inputs)
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sizes = {"H": H, "W": W, "ROI": ROI, "CAPACITY": CAPACITY}
    got = launch.run(mesh_rank_phase, 4, args=(MESH_INPUTS, sizes),
                     device=device, timeout=300, deadline=600)
    wall = time.perf_counter() - t0
    ref = mesh_references(device, inputs)
    same = {
        "batched": all(
            got["batched"][0][b].tobytes()
            == ref["batched"][b][0].cpu().numpy().tobytes()
            and all(h[b].tobytes() == r.cpu().numpy().tobytes()
                    for h, r in zip(got["batched"][1],
                                    ref["batched"][b][1]["loss_history"]))
            for b in range(2)),
        "multistart": got["multistart"][0][0].tobytes()
        == ref["multistart"][0].cpu().numpy().tobytes(),
        "sequential": all(
            got["sequential"][t][d].tobytes()
            == ref["sequential"][d][t].cpu().numpy().tobytes()
            for t in range(3) for d in range(2))}
    ms = got["ms"]
    print(f"mesh 2x2 on one card: backend {got['backend']}; 4 ranks in "
          f"{wall:.1f} s (start-up included); ms a step: batched (2 frames) "
          f"{ms['batched_step']:.1f}, multi-start (R = 4) "
          f"{ms['multistart_step']:.1f}, sequential "
          f"{[round(v, 1) for v in ms['sequential_steps']]}; all-reduce of "
          f"[2, {H}, {W}] float32 through the host "
          f"{ms['all_reduce_2x720x1280_f32']:.2f} ms; vote launches per "
          f"rank {got['votes']} ({got['votes_per_rank_events']} events "
          f"each); bit-identical to one process {same}")
    assert got["backend"] == "gloo", got["backend"]
    assert all(same.values()), same
    # the launch counter moves on the card only
    votes = 5.0 if torch.device(device).type == "cuda" else 0.0
    assert got["votes"] == [votes] * 4, got["votes"]
    return {"ms": ms, "seconds": wall, "votes": got["votes"],
            "backend": got["backend"]}


def run_wire_and_mesh(device, loader, gt):
    """Phase 13: the wire, the 1×1 mesh through ``cli.main``, four ranks
    sharing the card."""
    t0 = time.perf_counter()
    windows = loader_windows(loader, frames=(1,))
    out = {"uploads": check_uploads(device, windows[0])}
    out["wire_serving"] = run_wire_serving(device, loader, gt)
    out["mesh_cli"] = run_mesh_cli(device)
    out["rank_vote_err"] = check_rank_vote(device, windows[0])
    out["ranks"] = run_rank_mesh(device, loader)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 13: {out['seconds']:.1f} s")
    print(json.dumps({"wire_and_mesh": out}, default=str))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    launches, main_flow, main_ms = run_main_path(events, frame, gt_flow,
                                                 "cuda")
    entries[0]["launches"] = launches["hat_vote_image"]
    cmax_launches = run_cmax_path(events, gt_flow, "cuda")
    entries[0]["launches_cmax"] = cmax_launches["hat_vote_image"]
    for entry in entries[1:]:
        entry["launches"] = cmax_launches[entry["name"]]
    check_cmax_sharpens("cuda")
    check_small_reference("cuda")
    check_small_cmax("cuda")
    serving, mask_err, loader, gt = run_serving("cuda")
    pyr, cmax = serving["pyramid"], serving["cmax"]
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"], mask_err)
    entries[0]["launches_serving"] = pyr["vote_launches"]
    for entry in entries:
        entry["launches_serving_cmax"] = cmax["launches"][entry["name"]]
    visualize = run_visualize("cuda", loader, gt)
    entries[0]["launches_visualize"] = visualize["pyramid"]["vote_launches"]
    for entry in entries:
        entry["launches_visualize_cmax"] = visualize["cmax"]["launches"][
            entry["name"]]
    check_golden("cuda")
    modes = run_pyramid_modes(events, frame, gt_flow, main_flow, main_ms,
                              "cuda")
    entries[0]["launches_pyramid_modes"] = modes["votes"]
    ccs = run_ccs("cuda")
    entries[0]["launches_ccs"] = ccs["votes"]
    others = run_other_solvers("cuda", loader, gt)
    entries[0]["launches_other_solvers"] = others["votes"]
    remaining = run_remaining_ops("cuda", loader)
    entries[0]["launches_filters"] = remaining["filters"]
    entries[0]["launches_piv"] = remaining["piv"]
    entries[0]["launches_weighted_images"] = remaining["weighted_images"]
    wire_mesh = run_wire_and_mesh("cuda", loader, gt)
    entries[0]["launches_wire"] = wire_mesh["wire_serving"]["launches"]
    entries[0]["launches_mesh"] = wire_mesh["mesh_cli"]["launches"]
    entries[0]["launches_mesh_ranks"] = wire_mesh["ranks"]["votes"]
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"],
                                    wire_mesh["rank_vote_err"])
    for entry in entries[1:]:
        entry["launches_wire"] = entry["launches_mesh"] = 0

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
