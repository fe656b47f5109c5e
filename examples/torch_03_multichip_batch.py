"""Data-parallel frame batch across a mesh of ranks, in the PyTorch/CUDA
port.

The port of ``03_multichip_batch.py``.  Where the JAX example runs one
program over the devices of a process, the port runs one process a mesh
position: ``parallel.launch.run`` spawns ``--ranks`` ranks (default 4) on
``torch.distributed``, on the GPU unless asked for the CPU.  NCCL joins
them when every rank has a GPU of its own, gloo when they share one card
(or run on the CPU):

    python examples/torch_03_multichip_batch.py [--ranks 4] [--device cpu]

The events of each frame are split over the ``event`` axis (each rank votes
its slice into partial polarity planes; an ``all_reduce`` sums them) and
the pyramid solves run independently over the ``data`` axis.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import numpy as np
import torch

from event_based_bos_tpu_torch import events_from_ndarray
from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                      generate_sequence)
from event_based_bos_tpu_torch.parallel import (launch, make_mesh,
                                                make_multichip_estimator,
                                                make_multichip_sequential,
                                                stack_events)
from event_based_bos_tpu_torch.solver import GenerativeSpec, PyramidSpec
from event_based_bos_tpu_torch.solver.generative import initialize_params
from event_based_bos_tpu_torch.solver.pyramid import pyramid_grids, roi_mask


def rank_main(n_ranks: int) -> list:
    """One rank's part; every rank builds the same inputs from the same
    seeds.  Returns the lines to print (rank 0's are printed)."""
    mesh = make_mesh()  # splits the ranks between (data, event)
    batch = mesh.shape["data"]
    lines = [f"{n_ranks} ranks ({mesh.backend or 'no group'}) → mesh "
             f"{mesh.shape}; {batch} frames per step"]

    h, w = 96, 128
    seq = generate_sequence(SyntheticBosConfig(
        height=h, width=w, duration=(batch + 2) / 30, fps=30,
        events_per_frame=20_000, seed=0))

    gen = GenerativeSpec(image_size=(h, w), iwe_sigma=2.0,
                         weight_by_inverse_event_hist=True,
                         optimize_warp=True, poisson_model=True)
    spec = PyramidSpec(gen=gen, roi=(0, h, 0, w),
                       coarsest_patch=16, finest_patch=8, n_iter=60)

    evs = []
    frames = []
    for i in range(batch):
        lo = np.searchsorted(seq["events"][:, 2], i / 30)
        hi = np.searchsorted(seq["events"][:, 2], (i + 1) / 30)
        evs.append(events_from_ndarray(seq["events"][lo:hi],
                                       capacity=1 << 15, device=mesh.device))
        frames.append(seq["frames"][i + 1])
    ev_b = stack_events(evs)
    frames_b = torch.as_tensor(np.stack(frames), dtype=torch.float32,
                               device=mesh.device)
    # each frame's coarsest init, drawn in frame order from one seed
    generator = torch.Generator(mesh.device).manual_seed(0)
    shape = pyramid_grids(spec)[0].shape
    inits = torch.stack([initialize_params(generator, shape, gen, mesh.device)
                         for _ in range(batch)])
    mask = roi_mask(spec)

    step = make_multichip_estimator(spec, mesh)
    flows, loss_hist = step(ev_b, frames_b, mask, inits)
    lines.append(f"flows: {tuple(flows.shape)} finite: "
                 f"{bool(torch.isfinite(flows).all())}")
    lines.append("final finest-scale losses per frame: "
                 f"{np.round(loss_hist[-1][:, -1].cpu().numpy(), 4)}")

    # --- sequential mesh mode: scale the WARM-START chain instead ---
    # D contiguous frame segments advance in lockstep; each data lane warm
    # starts from its own previous frame, with the feedback params kept on
    # its leader's device (cli: mesh: {data: D, event: E, sequential: true}).
    d = mesh.shape["data"]
    step_cold, step_warm = make_multichip_sequential(
        spec, mesh, steady_spec=dataclasses.replace(spec, n_iter=30))
    ev_d = type(ev_b)(*(f[:d] for f in ev_b))
    fl, prev, _ = step_cold(ev_d, frames_b[:d], mask, inits[:d])
    fl, prev, _ = step_warm(ev_d, frames_b[:d], mask, prev, [True] * d)
    lines.append(f"sequential lockstep (cold 60 iters -> warm 30): "
                 f"{tuple(fl.shape)} finite: {bool(torch.isfinite(fl).all())}")
    return lines


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ranks", type=int, default=4)
    args = parser.parse_args(argv)
    lines = launch.run(rank_main, args.ranks, args=(args.ranks,),
                       device=args.device, deadline=900.0)
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
