"""Serving features of the PyTorch/CUDA port: the exact-ROI fast path,
sequential TPE, the quantized serving wire, the multi-start and the
warm-started steady schedule.

The port of ``05_serving_and_sweeps.py``.  No dataset needed; it runs on
the GPU unless asked for the CPU:

    python examples/torch_05_serving_and_sweeps.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import numpy as np
import torch

from event_based_bos_tpu_torch import events_from_ndarray, resolve_device
from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                      generate_sequence)
from event_based_bos_tpu_torch.solver import GenerativeSpec, PyramidSpec
from event_based_bos_tpu_torch.solver.pyramid import (estimate_frame,
                                                      roi_mask,
                                                      update_coarse_from_fine)
from event_based_bos_tpu_torch.tpe import run_tpe
from event_based_bos_tpu_torch.types import (decode_wire_events,
                                             encode_wire_events)

H, W = 128, 192


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = SyntheticBosConfig(height=H, width=W, duration=0.1, fps=30.0,
                             events_per_frame=12_000, max_displacement=2.0,
                             seed=0)
    seq = generate_sequence(cfg)
    events, frame = seq["events"], seq["frames"][1]

    # --- 1. Exact-ROI fast path: full-frame cost semantics, box-only
    #        compute ---
    gen = GenerativeSpec(image_size=(H, W), iwe_sigma=2.0,
                         weight_by_inverse_event_hist=True,
                         optimize_warp=True, poisson_model=True)
    spec = PyramidSpec(gen=gen, roi=(0, H, 32, 160), coarsest_patch=32,
                       finest_patch=8, n_iter=60, restrict_to_roi=True)
    ev = events_from_ndarray(events, capacity=1 << 14, device=dev)
    mask = roi_mask(spec)
    flow, _ = estimate_frame(ev, frame, mask,
                             torch.Generator(dev).manual_seed(0), spec,
                             device=dev)
    print(f"exact-ROI solve: flow {tuple(flow.shape)}, "
          f"|flow| mean {float(flow.abs().mean()):.3f}")

    # --- 2. Sequential TPE (optuna-default semantics) on any objective ---
    res = run_tpe(lambda x: float((x[0] - 1.2) ** 2 + (x[1] + 0.4) ** 2),
                  ([-3, -3], [3, 3]), n_trials=60, seed=0)
    print(f"TPE found {np.round(res.param, 3)} (loss {res.loss:.4f}) in 60 "
          "trials")

    # --- 3. Quantized serving wire: 5 B/event, bit-exact decode ---
    wire = encode_wire_events(events, capacity=1 << 14, include_t=False)
    nbytes = sum(np.asarray(v).nbytes for v in wire.values())
    ev_decoded = decode_wire_events(wire, device=dev)
    assert torch.equal(ev_decoded.x, ev.x) and torch.equal(ev_decoded.y, ev.y)
    print(f"wire upload: {nbytes / (1 << 14):.1f} B/event slot "
          f"(float32 SoA = 17), decode bit-exact")

    # --- 4. Multi-start: best-of-R restarts (split over the data axis of
    #        a mesh by parallel.make_multichip_multistart) ---
    ms = dataclasses.replace(spec, n_restarts=4, n_iter=24)
    _flow_ms, aux = estimate_frame(ev, frame, mask,
                                   torch.Generator(dev).manual_seed(0), ms,
                                   device=dev)
    print(f"multi-start best-of-4: final loss "
          f"{float(aux['loss_history'][-1][-1]):.4f}")

    # --- 5. Sequential warm starts + steady schedule: frame 0 runs the
    #        full n_iter, warm-started frames half of it.  The CLI wires
    #        this via warm_start: true + steady_n_iter in the solver
    #        config. ---
    steady = dataclasses.replace(spec, n_iter=30)
    generator, prev = torch.Generator(dev).manual_seed(1), None
    for i in range(3):
        fr = seq["frames"][min(i + 1, len(seq["frames"]) - 1)]
        s = spec if prev is None else steady
        _flow_i, aux = estimate_frame(ev, fr, mask, generator, s,
                                      prev_params=prev, device=dev)
        prev = update_coarse_from_fine(aux["params_per_scale"], s)
        steps = len(aux["loss_history"][-1])
        print(f"frame {i}: {'cold' if i == 0 else 'steady'} schedule, "
              f"{steps} finest-scale steps, final loss "
              f"{float(aux['loss_history'][-1][-1]):.4f}")


if __name__ == "__main__":
    main()
