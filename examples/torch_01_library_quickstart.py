"""Library quickstart of the PyTorch/CUDA port: events → warp → IWE →
contrast, and its gradient.

The port of ``01_library_quickstart.py``.  No dataset needed; it runs on
the GPU unless asked for the CPU:

    python examples/torch_01_library_quickstart.py [--device cpu]

On a CUDA tensor ``ops.create_iwe`` votes through the hand-written CUDA
kernel (``csrc/hat_vote.cu``), which has no backward; the gradient goes
through ``ops.bilinear_vote``, the differentiable scatter with the same
votes.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from event_based_bos_tpu_torch import events_from_ndarray, resolve_device
from event_based_bos_tpu_torch.ops import (bilinear_vote, create_iwe,
                                           gaussian_blur, warp_event)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    h, w, n = 120, 160, 30_000
    rng = np.random.default_rng(0)

    # a moving edge pattern: events drift by (2, -1) px over the window
    true_flow = np.array([2.0, -1.0])
    t = np.sort(rng.uniform(0.0, 1.0, n))
    x = rng.uniform(10, h - 10, n) + true_flow[0] * t
    y = rng.uniform(10, w - 10, n) + true_flow[1] * t
    p = rng.integers(0, 2, n) * 2 - 1
    ev = events_from_ndarray(np.stack([x, y, t, p], 1), capacity=1 << 15,
                             device=dev)

    def warped(flow_2):
        dense = flow_2[:, None, None].expand(2, h, w)
        return warp_event(ev, dense, "dense-flow", direction="first")

    def contrast_at(flow_2):
        """Variance of the image of warped events (CMax objective)."""
        return torch.var(create_iwe(warped(flow_2), (h, w), sigma=1),
                         correction=0)

    def differentiable_contrast(flow_2):
        iwe = gaussian_blur(bilinear_vote(warped(flow_2), (h, w)), 1)
        return torch.var(iwe, correction=0)

    # the true motion maximizes contrast; gradients flow through the warp
    out = {"contrast": {}}
    with torch.no_grad():
        for c in [(0.0, 0.0), (2.0, -1.0), (-2.0, 1.0)]:
            value = float(contrast_at(torch.tensor(c, device=dev)))
            out["contrast"][c] = value
            print(f"flow {c}: contrast {value:.6f}")
    zero = torch.zeros(2, device=dev, requires_grad=True)
    (g,) = torch.autograd.grad(differentiable_contrast(zero), zero)
    out["grad"] = g.cpu().numpy()
    print("grad of contrast at 0 (points toward the motion):", out["grad"])
    return out


if __name__ == "__main__":
    main()
