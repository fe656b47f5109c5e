"""Solve one synthetic BOS frame with the port's pyramid solver.

The port of ``02_solve_synthetic_frame.py``: a simulated Schlieren
recording (no dataset needed), the coarse-to-fine solve, and the EPE
against the simulator's true displacement field.  It runs on the GPU
unless asked for the CPU:

    python examples/torch_02_solve_synthetic_frame.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from event_based_bos_tpu_torch import events_from_ndarray, resolve_device
from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                      generate_sequence)
from event_based_bos_tpu_torch.solver import GenerativeSpec, PyramidSpec
from event_based_bos_tpu_torch.solver.pyramid import estimate_frame, roi_mask
from event_based_bos_tpu_torch.types import bucket_capacity


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    h, w = 240, 320

    # a fast plume (like the benchmark workload) so the true displacement is
    # well above the zero-flow baseline
    seq = generate_sequence(SyntheticBosConfig(
        height=h, width=w, duration=2 / 30, fps=30,
        events_per_frame=60_000, max_displacement=3.0, plume_speed=900.0,
        seed=0))
    events = seq["events"]
    frame = seq["frames"][1]
    gt = seq["gt_flow"][0]  # true pattern displacement [2, H, W]

    gen = GenerativeSpec(image_size=(h, w), iwe_sigma=2.0,
                         weight_by_inverse_event_hist=True,
                         optimize_warp=True, poisson_model=True)
    spec = PyramidSpec(gen=gen, roi=(0, h, 0, w), coarsest_patch=32,
                       finest_patch=8, n_iter=600)

    ev = events_from_ndarray(events, capacity=bucket_capacity(len(events)),
                             device=dev)
    flow, aux = estimate_frame(ev, frame, roi_mask(spec),
                               torch.Generator(dev).manual_seed(0), spec,
                               device=dev)

    # the solver returns the reference convention = −displacement
    pred = -flow.cpu().numpy()
    err = np.linalg.norm(pred - gt, axis=0)
    mag = np.linalg.norm(gt, axis=0)
    # evaluate where the flow actually is (the plume): whole-frame EPE is
    # dominated by the quiet background
    plume = mag > 0.3
    out = {"plume_epe": float(err[plume].mean()),
           "plume_zero_epe": float(mag[plume].mean()),
           "epe": float(err.mean()), "zero_epe": float(mag.mean())}
    print(f"plume covers {100 * plume.mean():.1f}% of the frame")
    print(f"EPE on the plume: {out['plume_epe']:.3f} px "
          f"(zero-flow baseline {out['plume_zero_epe']:.3f} px)")
    print(f"whole-frame EPE:  {out['epe']:.3f} px "
          f"(zero-flow baseline {out['zero_epe']:.3f} px)")
    print("final losses per scale:",
          [float(hh[-1]) for hh in aux["loss_history"]])
    return out


if __name__ == "__main__":
    main()
