"""One run of the mesh steps over an n-rank mesh at a tiny size.

    python -c "from event_based_bos_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4)"

The port's counterpart of the JAX package's ``dryrun_multichip``: the
batched step (frames over ``data``, events over ``event``) and the cold
and warm sequential steps, on 32×48 frames, with ranks spawned on the GPU
(gloo when they share it) unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dryrun_multichip"]


def _flagship(image_size, n_iter, coarsest):
    from ..solver import GenerativeSpec, PyramidSpec

    h, w = image_size
    gen = GenerativeSpec(image_size=image_size, iwe_sigma=2.0,
                         weight_by_inverse_event_hist=True,
                         optimize_warp=True, poisson_model=True)
    return PyramidSpec(gen=gen, roi=(0, h, 0, w), coarsest_patch=coarsest,
                       finest_patch=8, n_iter=n_iter)


def _dryrun_rank(n_devices: int) -> str:
    import dataclasses

    import torch

    from ..solver.generative import initialize_params
    from ..solver.pyramid import pyramid_grids, roi_mask
    from ..types import events_from_ndarray
    from .mesh import make_mesh
    from .sharding import make_multichip_estimator, make_multichip_sequential
    from .sweep import stack_events

    d = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh((d, n_devices // d), ("data", "event"))
    image_size = (32, 48)
    capacity = 2048 * (n_devices // d)
    batch = 2 * d
    spec = _flagship(image_size, n_iter=6, coarsest=16)
    rng = np.random.default_rng(0)
    evs = [events_from_ndarray(np.stack([
        rng.uniform(0, image_size[0] - 1, capacity),
        rng.uniform(0, image_size[1] - 1, capacity),
        np.sort(rng.uniform(0, 0.01, capacity)),
        rng.integers(0, 2, capacity) * 2.0 - 1.0], axis=-1),
        capacity=capacity, device=mesh.device) for _ in range(batch)]
    ev = stack_events(evs)
    frames = torch.as_tensor(rng.uniform(0, 255, (batch,) + image_size),
                             dtype=torch.float32, device=mesh.device)
    mask = roi_mask(spec)
    # every rank draws the same inits from the same seed
    gen = torch.Generator(mesh.device).manual_seed(0)
    shape = pyramid_grids(spec)[0].shape
    inits = torch.stack([initialize_params(gen, shape, spec.gen, mesh.device)
                         for _ in range(batch)])

    step = make_multichip_estimator(spec, mesh)
    flows, losses = step(ev, frames, mask, inits)
    assert flows.shape == (batch, 2) + image_size
    assert bool(torch.isfinite(flows).all())

    step_cold, step_warm = make_multichip_sequential(
        spec, mesh, steady_spec=dataclasses.replace(spec, n_iter=3))
    ev_d = type(ev)(*(f[:d] for f in ev))
    sflows, prev, _ = step_cold(ev_d, frames[:d], mask, inits[:d])
    sflows, prev, _ = step_warm(ev_d, frames[:d], mask, prev, [True] * d)
    assert bool(torch.isfinite(sflows).all())
    return (f"dryrun_multichip OK: mesh={mesh.shape} "
            f"flows={tuple(flows.shape)} final losses="
            f"{losses[-1][:, -1].cpu().numpy()} sequential-step OK ({d} warm "
            f"lanes, backend {mesh.backend})")


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Run the steps once over an ``n_devices``-rank mesh (spawned ranks on
    ``device``'s type: the GPU unless the caller asks for the CPU) and
    print rank 0's OK line; returns it."""
    from .launch import run

    line = run(_dryrun_rank, n_devices, args=(n_devices,), device=device,
               deadline=600.0)
    print(line)
    return line
