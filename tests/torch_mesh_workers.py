"""Rank workers of the port's mesh tests (``test_torch_parallel.py``,
``test_torch_cli.py``).

Spawned ranks import the module of the function they run, so this module
imports nothing of JAX (and nothing that does): a rank group pays torch
and the port alone.  Every input is made here from a seed with numpy, so
the test process can rebuild it for the single-process and JAX
references.
"""

import builtins
import os

import numpy as np
import torch
import torch.distributed as dist

SIZE = (48, 64)  # a 3-row coarsest grid at 16-px patches
N_EVENTS = 1024


def spec(n_iter=12, n_restarts=1, dtype=torch.float64):
    from event_based_bos_tpu_torch.solver import GenerativeSpec, PyramidSpec

    h, w = SIZE
    gen = GenerativeSpec(image_size=SIZE, iwe_sigma=2.0,
                         weight_by_inverse_event_hist=True,
                         optimize_warp=True, poisson_model=True, dtype=dtype)
    return PyramidSpec(gen=gen, roi=(0, h, 8, w - 8), coarsest_patch=16,
                       finest_patch=8, n_iter=n_iter, n_restarts=n_restarts)


def event_arrays(batch, seed, fractional=False, n=N_EVENTS):
    """``[batch]`` ``(n, 4)`` windows: integer sensor coordinates (or
    fractional ones), ±1 polarity."""
    rng = np.random.default_rng(seed)
    out = []
    h, w = SIZE
    for _ in range(batch):
        if fractional:
            x, y = rng.uniform(0, h - 1, n), rng.uniform(0, w - 1, n)
        else:
            x, y = rng.integers(0, h, n), rng.integers(0, w, n)
        out.append(np.stack([x, y, np.sort(rng.uniform(0, 0.01, n)),
                             rng.integers(0, 2, n) * 2.0 - 1.0], 1))
    return out


def frames(batch, seed):
    return np.random.default_rng(seed).uniform(0, 255, (batch,) + SIZE)


def inits(count, seed, shape=(3, 3, 4)):
    """``count`` coarsest-scale inits (poisson base in [-1, 1))."""
    out = np.zeros((count,) + shape)
    out[:, 0] = np.random.default_rng(seed).uniform(-1, 1,
                                                    (count,) + shape[1:])
    return out


def stacked(arrays, dtype=torch.float64, device="cpu"):
    from event_based_bos_tpu_torch.parallel import stack_events
    from event_based_bos_tpu_torch.types import events_from_ndarray

    return stack_events([events_from_ndarray(a, capacity=len(a), dtype=dtype,
                                             device=device)
                         for a in arrays])


def _np(t):
    return t.detach().cpu().numpy()


def _flag_sum(values):
    """Sum of each rank's flags (a CPU all-reduce over the world)."""
    t = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t)
    return t.numpy()


def parallel_cases():
    """Every parallel case on one 2×2 rank group; rank 0's results."""
    import dataclasses

    from event_based_bos_tpu_torch.parallel import (
        hyperparam_sweep, make_mesh, make_multichip_estimator,
        make_multichip_multistart, make_multichip_sequential,
        sharded_polarity_votes)
    from event_based_bos_tpu_torch.solver.pyramid import roi_mask

    out = {}
    mesh = make_mesh()
    out["default_shape"] = mesh.axis_shape
    out["backend"] = mesh.backend
    s = spec()
    mask = roi_mask(s)

    for frac in (False, True):
        ev = stacked(event_arrays(4, 1, fractional=frac))
        out[f"votes_frac{frac}"] = _np(sharded_polarity_votes(ev, s.gen,
                                                              mesh))

    # the batched step: distinct inits, and one shared init
    ev = stacked(event_arrays(2, 2))
    fr = frames(2, 3)
    step = make_multichip_estimator(s, mesh)
    for tag, x0 in (("", inits(2, 4)), ("_shared", inits(1, 5)[[0, 0]])):
        flows, hists = step(ev, fr, mask, x0)
        out[f"estimator{tag}"] = (_np(flows), [_np(h) for h in hists])

    # the multi-start: R = 4 over data 2
    s4 = spec(n_restarts=4)
    ms = make_multichip_multistart(s4, mesh)
    ev1 = stacked(event_arrays(1, 6))
    fr1 = frames(1, 7)
    for tag, x0 in (("", inits(4, 8)), ("_shared", inits(1, 5)[[0] * 4])):
        flow, hists = ms(ev1, fr1, mask, x0)
        out[f"multistart{tag}"] = (_np(flow), [_np(h) for h in hists])
    try:
        make_multichip_multistart(spec(n_restarts=3), mesh)
    except ValueError as e:
        out["indivisible"] = str(e)

    # two sequential lanes × three steps, the steady schedule from step 1
    steady = dataclasses.replace(s, n_iter=6)
    cold, warm = make_multichip_sequential(s, mesh, steady_spec=steady)
    for tag, x0 in (("", inits(2, 9)), ("_shared", inits(1, 5)[[0, 0]])):
        prev, seq = None, []
        for t in range(3):
            ev_t = stacked(event_arrays(2, 10 + t))
            fr_t = frames(2, 20 + t)
            if t == 0:
                flows, prev, _ = cold(ev_t, fr_t, mask, x0)
            else:
                flows, prev, _ = warm(ev_t, fr_t, mask, prev, [True, True])
            seq.append(_np(flows))
        out[f"sequential{tag}"] = seq
    # carry_valid False keeps lane 0's prev bit for bit (its leader is
    # rank 0), True moves lane 1's (rank 2)
    ev_t = stacked(event_arrays(2, 13))
    _f, kept, _ = warm(ev_t, frames(2, 23), mask, prev, [False, True])
    flags = [0.0, 0.0]
    if mesh.coords == (0, 0):
        flags[0] = float(all(torch.equal(a, b) for a, b in zip(kept, prev)))
    if mesh.coords == (1, 0):
        flags[1] = float(any(not torch.equal(a, b)
                             for a, b in zip(kept, prev)))
    out["carry"] = _flag_sum(flags)

    # the sweep: four (lr, init) lanes over data 2, one frame
    ev_s = stacked(event_arrays(1, 30))
    lrs = [0.01, 0.05, 0.1, 0.3]
    flows, losses = hyperparam_sweep(
        type(ev_s)(*(f[0] for f in ev_s)), frames(1, 31)[0], mask, lrs,
        inits(4, 32), spec(n_iter=8), mesh)
    out["sweep"] = (_np(flows), _np(losses))
    return out


def bad_mesh():
    """A 3×1 mesh in a group of two ranks (raises)."""
    from event_based_bos_tpu_torch.parallel import make_mesh

    return make_mesh((3, 1))


def cli_runs(argvs, init):
    """``cli.main`` on each of ``argvs`` in this rank group, every cold
    frame from ``init`` (``solver.pyramid.initialize_params`` returns it);
    a rank other than 0 that writes under an output directory raises."""
    import event_based_bos_tpu_torch.cli as tcli
    import event_based_bos_tpu_torch.solver.pyramid as pyramid

    pyramid.initialize_params = (
        lambda generator, shape, spec, device=None:
        torch.as_tensor(init, dtype=spec.dtype, device=device))
    if dist.get_rank() != 0:
        _forbid_writes(argvs)
    for argv in argvs:
        assert tcli.main(argv, device="cpu") == 0
    return dist.get_world_size()


def _forbid_writes(argvs):
    import yaml

    dirs = []
    for argv in argvs:
        with open(argv[argv.index("--config_file") + 1]) as f:
            dirs.append(os.path.abspath(yaml.safe_load(f)["output_dir"]))
    real_open, real_save = builtins.open, np.save

    def inside(path):
        p = os.path.abspath(str(path))
        return any(p == d or p.startswith(d + os.sep) for d in dirs)

    def guarded_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+") and inside(file):
            raise AssertionError(f"rank {dist.get_rank()} wrote {file}")
        return real_open(file, mode, *args, **kwargs)

    def guarded_save(file, *args, **kwargs):
        if inside(file):
            raise AssertionError(f"rank {dist.get_rank()} wrote {file}")
        return real_save(file, *args, **kwargs)

    builtins.open = guarded_open
    np.save = guarded_save
