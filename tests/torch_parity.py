"""Shared inputs for the parity tests of the PyTorch port (``test_torch_*``).

Every input is made with numpy from a fixed seed and handed to both the
JAX package and the port, so the two see identical numbers.
"""

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
