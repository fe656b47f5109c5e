"""Extend the cost registry of the PyTorch/CUDA port with a custom term and
solve with it.

The port of ``04_custom_cost.py``.  The cost layer is a plain function
registry (``costs.functions``): a cost is ``arg_dict → scalar`` and takes
part in ``hybrid_cost`` weighting and the per-term loss history exactly
like the built-ins.  It runs on the GPU unless asked for the CPU:

    python examples/torch_04_custom_cost.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from event_based_bos_tpu_torch import (costs, events_from_ndarray,
                                       resolve_device)
from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                      generate_sequence)
from event_based_bos_tpu_torch.solver import GenerativeSpec, PyramidSpec
from event_based_bos_tpu_torch.solver.pyramid import estimate_frame, roi_mask


def divergence_penalty(arg: dict) -> torch.Tensor:
    """Penalize compressive flow (BOS displacements are near-solenoidal)."""
    flow = arg["flow"]
    div = (torch.gradient(flow[0], dim=0)[0]
           + torch.gradient(flow[1], dim=1)[0])
    return torch.mean(torch.abs(div))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    costs.functions["divergence"] = divergence_penalty

    h, w = 96, 128
    seq = generate_sequence(SyntheticBosConfig(
        height=h, width=w, duration=2 / 30, fps=30,
        events_per_frame=20_000, seed=0))

    gen = GenerativeSpec(
        image_size=(h, w), iwe_sigma=2.0,
        weight_by_inverse_event_hist=True, optimize_warp=True,
        poisson_model=True,
        cost_weights=(("diff_norm", 1.0), ("image_gradient", 0.5),
                      ("flow_norm_pxy", 0.1), ("divergence", 0.2)),
    )
    spec = PyramidSpec(gen=gen, roi=(0, h, 0, w), coarsest_patch=16,
                       finest_patch=8, n_iter=60)
    ev = events_from_ndarray(seq["events"], capacity=1 << 16, device=dev)
    flow, aux = estimate_frame(ev, seq["frames"][1], roi_mask(spec),
                               torch.Generator(dev).manual_seed(0), spec,
                               device=dev)
    hist = aux["term_history"][-1]
    print("per-term losses at the last finest-scale iteration:")
    losses = {}
    for name, vals in hist.items():
        losses[name] = float(vals[-1])
        print(f"  {name:>16s}: {losses[name]:.5f}")
    finite = bool(torch.isfinite(flow).all())
    print("flow finite:", finite)
    return {"losses": losses, "finite": finite}


if __name__ == "__main__":
    main()
