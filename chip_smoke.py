#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``event_based_bos_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``; imports nothing of JAX.  Phases, each of which raises on
failure:

1. card identity (``nvidia-smi`` name and power limit) and TF32 switched off;
2. build of every CUDA kernel from ``event_based_bos_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes (2^19 events, 720×1280): the signed vote bit-exact on
   integer coordinates, ≤ 1e-5 on fractional / out-of-frame coordinates
   with padding and weights and on a masked batch; kernel, plain and
   library-call times against the HBM bound;
4. the main path at full width — the ``bench.py`` workload and spec: the
   IWE cache on the card, then ``estimate_frame`` (64→8 patches, 600
   iterations) — one warm-up frame, three timed frames and one frame that
   counts host synchronisations; the flow must be finite, exactly +0.0
   outside the ROI, launched through the kernel, the same bit for bit in
   the three timed frames (same inputs and seed), and within 0.30 px EPE
   of the synthetic ground truth;
5. a small float64 scene solved on the card and on the CPU, which must
   agree to 1e-6.

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

H, W = 720, 1280
ROI = (0, 720, 320, 960)
N_ITER = 600
CAPACITY = 1 << 19
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
F32_FLOPS = 67e12           # H100 SXM, f32 outside the tensor cores
EPE_LIMIT = 0.30


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
    (outside the timed span) to evict the inputs from L2."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def check_vote_kernel(events, device):
    """Phase 3: the vote kernel against its plain version, full size."""
    import numpy as np
    import torch

    from event_based_bos_tpu_torch import events_from_ndarray, kernels
    from event_based_bos_tpu_torch.ops import iwe, iwe_cuda

    dev = torch.device(device)
    ev = events_from_ndarray(events, capacity=CAPACITY, device=dev)
    sign = torch.where(ev.p > 0, 1.0, -1.0)

    # the signed vote, integer sensor coordinates: bit-exact
    got = iwe_cuda.signed_vote_cuda(ev, (H, W))
    x = torch.where(ev.valid, ev.x, -2.0).contiguous()
    y = torch.where(ev.valid, ev.y, -2.0).contiguous()
    v = torch.where(ev.valid, sign, 0.0).contiguous()
    plain = iwe_cuda.hat_vote_plain(x, y, v, (H, W))
    scatter = iwe.bilinear_vote(ev, (H, W), weight=sign)
    torch.cuda.synchronize()
    assert torch.equal(got, plain), "signed vote differs from its plain version"
    assert torch.equal(got, scatter), "signed vote differs from the scatter"
    print(f"vote integer coords: bit-exact vs plain and scatter "
          f"(|sum| {float(got.abs().sum()):.0f}, live events "
          f"{int(ev.count())})")

    # a masked batch: still bit-exact
    rng = np.random.default_rng(1)
    keep = torch.as_tensor(rng.integers(0, 2, CAPACITY) > 0, device=dev)
    masked = ev.mask_where(keep)
    got_m = iwe_cuda.signed_vote_cuda(masked, (H, W))
    sign_m = torch.where(masked.p > 0, 1.0, -1.0)
    assert torch.equal(got_m, iwe.bilinear_vote(masked, (H, W),
                                                 weight=sign_m)), \
        "masked signed vote differs from the scatter"
    print("vote masked batch: bit-exact vs scatter")

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
    xf = (torch.where(frac.valid, fx, -2.0) + ph).contiguous()
    yf = (torch.where(frac.valid, fy, -2.0) + pw).contiguous()
    vf = torch.where(frac.valid, wgt, 0.0).contiguous()
    plain_f = iwe_cuda.hat_vote_plain(xf, yf, vf, (H + 2 * ph, W + 2 * pw))
    scatter_f = iwe.bilinear_vote(frac, (H, W), wgt, (ph, pw))
    err_plain = float((got_f - plain_f).abs().max())
    err_scatter = float((got_f - scatter_f).abs().max())
    assert got_f.shape == (H + 2 * ph, W + 2 * pw)
    assert err_plain <= 1e-5, f"fractional vote vs plain: {err_plain:.3e}"
    # The scatter floors the unshifted coordinate (with its 1e-6 nudge); the
    # kernel sees x + ph, whose f32 rounding at ~1280 px moves the hat
    # weights by up to ulp(1280)/2 = 6e-5 each.  A wrong corner would cost
    # O(1), so 1e-3 separates the two.
    assert err_scatter <= 1e-3, f"fractional vote vs scatter: {err_scatter:.3e}"
    print(f"vote fractional/out-of-frame, padding {(ph, pw)}, weights, "
          f"masked: max|diff| {err_plain:.3e} vs plain (limit 1e-5), "
          f"{err_scatter:.3e} vs the unshifted scatter (limit 1e-3)")

    # times at the main path's shapes (the integer-coordinate signed vote)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    kernel_ms = cuda_ms(lambda: iwe_cuda.hat_vote_image(x, y, v, (H, W)),
                        flush=flush)
    plain_ms = cuda_ms(lambda: iwe_cuda.hat_vote_plain(x, y, v, (H, W)),
                       flush=flush)
    # library yardstick: index_add_ of the 4·n corner votes, built beforehand
    r0 = torch.floor(x).clamp(-2, H).long()
    c0 = torch.floor(y).clamp(-2, W).long()
    idx, val = [], []
    for a in (0, 1):
        for b in (0, 1):
            r, c = r0 + a, c0 + b
            inb = (r >= 0) & (r < H) & (c >= 0) & (c < W)
            wr = (1 - (x - torch.floor(x))) if a == 0 else x - torch.floor(x)
            wc = (1 - (y - torch.floor(y))) if b == 0 else y - torch.floor(y)
            idx.append(torch.where(inb, r * W + c, 0))
            val.append(torch.where(inb, wr * wc * v, 0.0))
    idx, val = torch.cat(idx), torch.cat(val)
    library_ms = cuda_ms(
        lambda: torch.zeros(H * W, device=dev).index_add_(0, idx, val),
        flush=flush)
    n = x.numel()
    bytes_moved = 3 * 4 * n + 4 * H * W
    live = int((v != 0).sum())
    flops = 18 * live  # floors, offsets, corner products, 4 atomic adds
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    bound_by = ("bytes" if bytes_moved / HBM_BYTES_PER_S
                >= flops / F32_FLOPS else "operations")
    print(f"vote times (median of 20, L2 flushed): kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, "
          f"bound {bound_ms * 1e3:.2f} us ({bytes_moved} B, {bound_by})")
    del flush_buf
    kernels.reset_launches()
    return {"name": "hat_vote_image", "route": "cuda",
            "source": "event_based_bos_tpu_torch/csrc/hat_vote.cu",
            "replaces": "event_based_bos_tpu/ops/iwe_pallas.py:153",
            "max_abs_err": err_plain, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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
          f"EPE {epe:.4f} px (zero-flow {zero_epe:.4f} px), "
          f"vote launches {launches['hat_vote_image']} over 5 frames, "
          f"host syncs in one frame {syncs}, timed frames bit-identical "
          f"{repeatable}, peak memory {peak_gib:.2f} GiB, "
          f"final loss per scale {[round(v, 5) for v in losses]}")
    assert flow_np.shape == (2, H, W) and np.isfinite(flow_np).all()
    assert (flow_np[:, outside] == 0).all()
    assert not np.signbit(flow_np[:, outside]).any(), "−0.0 outside the ROI"
    assert launches["hat_vote_image"] > 0, "the main path skipped the kernel"
    assert repeatable, "the same frame and seed gave different flows"
    assert epe < EPE_LIMIT, f"EPE {epe:.4f} px ≥ {EPE_LIMIT}"
    return launches


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

    built = kernels.build()
    kernels.library()
    print(f"build: {built['seconds']:.1f} s -> {built['path']}")
    for line in str(built["log"]).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    events, frame, gt_flow = make_workload()
    print(f"workload: {len(events)} events, {H}x{W} "
          f"({time.perf_counter() - t0:.1f} s to generate)")

    entry = check_vote_kernel(events, "cuda")
    launches = run_main_path(events, frame, gt_flow, "cuda")
    entry["launches"] = launches[entry["name"]]
    check_small_reference("cuda")

    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
