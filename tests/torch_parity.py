"""Shared inputs for the parity tests of the PyTorch port (``test_torch_*``).

Every input is made with numpy from a fixed seed and handed to both the
JAX package and the port, so the two see identical numbers.
"""

import contextlib
import functools

import numpy as np
import torch

import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.types as ttypes
from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                      generate_sequence)

CPU = "cpu"


def np_of(a):
    """numpy view of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rand_event_fields(n, h, w, rng, fractional=False, spread=1.5):
    """``(x, y, t, p)`` float32 arrays; fractional coordinates also fall
    ``spread`` px outside the frame."""
    if fractional:
        x = rng.uniform(-spread, h - 1 + spread, n)
        y = rng.uniform(-spread, w - 1 + spread, n)
    else:
        x = rng.integers(0, h, n)
        y = rng.integers(0, w, n)
    p = rng.integers(0, 2, n) * 2 - 1
    t = np.sort(rng.uniform(0, 1, n))
    return tuple(a.astype(np.float32) for a in (x, y, t, p))


def both_events(fields, keep=None, capacity=None):
    """The same events as a JAX ``Events`` and a port ``Events`` (CPU)."""
    jev = jtypes.events_from_arrays(*fields, capacity=capacity)
    tev = ttypes.events_from_arrays(*fields, capacity=capacity, device=CPU)
    if keep is not None:
        jev = jev.mask_where(np.asarray(keep[:jev.capacity]))
        tev = tev.mask_where(torch.as_tensor(keep[:tev.capacity]))
    return jev, tev


@functools.lru_cache(maxsize=None)
def small_scene(h=64, w=96, n=2000, seed=0):
    """A small synthetic BOS window: ``(events (n, 4), frame, gt_flow)``."""
    cfg = SyntheticBosConfig(height=h, width=w, duration=1.0 / 30.0,
                             fps=30.0, events_per_frame=n,
                             max_displacement=3.0, plume_speed=300.0,
                             seed=seed)
    seq = generate_sequence(cfg)
    return seq["events"], seq["frames"][1], seq["gt_flow"][0]


def rel_err(a, b):
    a, b = np_of(a), np_of(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


SMALL_ROI = {"xmin": 0, "xmax": 64, "ymin": 16, "ymax": 80}


def small_config(name="synthetic_plume", output_dir=None, **top):
    """A shipped YAML config cut to a small scene (64×96, a few Adam steps
    per scale, float64, ``visualize: false``, frames 0–2 of
    ``time_list``), as a dict not yet propagated; ``top`` overrides
    top-level keys."""
    import pathlib

    import yaml

    path = pathlib.Path(__file__).resolve().parent.parent / "configs"
    with open(path / f"{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(height=64, width=96, duration=0.2, fps=30,
                       events_per_frame=3000)
    cfg["common_params"].update(SMALL_ROI)
    cfg["evaluation"]["time_list"] = [[0.01, 0.18]]
    solver = cfg["solver"]
    solver["precision"] = "64"
    if name == "synthetic_cmax":
        solver["optimizer"]["n_iter"] = 30
    else:
        solver["optimizer"]["n_iter"] = 12
        solver["patch_eklt"].update(coarsest_patch_size=16,
                                    finest_patch_size=8)
    cfg["visualize"] = False
    if output_dir is not None:
        cfg["output_dir"] = str(output_dir)
    cfg.update(top)
    return cfg


def pyramid_init(cfg, seed=7):
    """A numpy init of the coarsest pyramid scale for ``cfg`` (three
    parameter planes; the first drawn uniformly in [-1, 1))."""
    pe = cfg["solver"]["patch_eklt"]
    h, w = cfg["data"]["height"], cfg["data"]["width"]
    p = pe["coarsest_patch_size"]
    init = np.zeros((3, h // p, w // p))
    init[0] = np.random.default_rng(seed).uniform(-1, 1, init.shape[1:])
    return init


def inject_init(monkeypatch, facades_module, init):
    """Make ``facades_module``'s solves start from ``init`` on every cold
    frame: its ``estimate_frame`` name is wrapped to pass ``init_params``
    (a warm-started frame keeps its previous-frame start)."""
    orig = facades_module.estimate_frame

    def estimate_frame(*args, **kwargs):
        if kwargs.get("prev_params") is None:
            kwargs["init_params"] = init
        return orig(*args, **kwargs)

    monkeypatch.setattr(facades_module, "estimate_frame", estimate_frame)


@contextlib.contextmanager
def torch_threads(n):
    """Run the block with ``n`` torch intra-op threads.  The solves of the
    facade and CLI tests are many small ops; under the suite's parallel
    workers, threads of each waiting on the others' cores cost far more
    than they save."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
