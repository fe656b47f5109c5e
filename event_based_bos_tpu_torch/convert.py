"""The state that crosses between the JAX package and the port.

The system has no trained weights.  What one package can hand the other is
the solver state, as numpy arrays:

  * ``init_params`` — the coarsest-scale parameter field ``[n_dim, gh, gw]``
    of the pyramid, or the joint tiled solver's whole field;
  * ``x0`` — the whole-ROI (GML) solver's parameter vector ``[d]``;
  * ``params_per_scale`` / ``prev_params`` — per-scale fields, coarsest
    first (the warm-start state);
  * ``cache`` — the IWE cache ``(histogram, weights | None,
    weight_inverse)``, each ``[H, W]``;
  * ``events`` — the ``Events`` fields ``(x, y, t, p, valid)``.

:func:`state_from_numpy` checks shapes and dtypes and moves the arrays onto
a device as tensors; :func:`state_to_numpy` goes back.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .types import Events

__all__ = ["state_from_numpy", "state_to_numpy"]

_KEYS = ("init_params", "x0", "params_per_scale", "prev_params", "cache",
         "events")


def _float_array(name: str, a, ndim: int) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype not in (np.float32, np.float64):
        raise TypeError(f"{name}: expected float32/float64, got {a.dtype}")
    if a.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {a.shape}")
    return a


def state_from_numpy(state: Dict[str, object], device=None,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
    """numpy state → tensors on ``device`` (the GPU unless asked).

    ``dtype`` casts the float arrays (default: keep each array's own).
    Unknown keys, wrong ranks, non-float fields, mismatched cache shapes and
    ragged event fields raise.
    """
    unknown = set(state) - set(_KEYS)
    if unknown:
        raise KeyError(f"unknown state keys {sorted(unknown)}")
    dev = resolve_device(device)

    def tensor(name, a, ndim):
        t = torch.tensor(_float_array(name, a, ndim))
        return t.to(device=dev, dtype=dtype or t.dtype)

    out: Dict[str, object] = {}
    if state.get("init_params") is not None:
        out["init_params"] = tensor("init_params", state["init_params"], 3)
    if state.get("x0") is not None:
        out["x0"] = tensor("x0", state["x0"], 1)
    for key in ("params_per_scale", "prev_params"):
        if state.get(key) is not None:
            out[key] = [tensor(f"{key}[{i}]", a, 3)
                        for i, a in enumerate(state[key])]
    if state.get("cache") is not None:
        hist, weights, winv = state["cache"]
        hist_t = tensor("cache.histogram", hist, 2)
        weights_t = (None if weights is None
                     else tensor("cache.weights", weights, 2))
        winv_t = tensor("cache.weight_inverse", winv, 2)
        for name, t in (("weights", weights_t), ("weight_inverse", winv_t)):
            if t is not None and t.shape != hist_t.shape:
                raise ValueError(f"cache.{name} shape {tuple(t.shape)} != "
                                 f"histogram shape {tuple(hist_t.shape)}")
        out["cache"] = (hist_t, weights_t, winv_t)
    if state.get("events") is not None:
        x, y, t, p, valid = state["events"]
        fields = [tensor(f"events.{n}", a, 1)
                  for n, a in zip("xytp", (x, y, t, p))]
        valid = np.asarray(valid)
        if valid.dtype != np.bool_ or valid.ndim != 1:
            raise TypeError("events.valid must be a 1-D bool array")
        if any(f.shape[0] != valid.shape[0] for f in fields):
            raise ValueError("event fields differ in length")
        out["events"] = Events(*fields, torch.tensor(valid).to(dev))
    return out


def state_to_numpy(state: Dict[str, object]) -> Dict[str, object]:
    """The inverse of :func:`state_from_numpy` (host copies)."""

    def arr(t):
        return None if t is None else t.detach().cpu().numpy()

    out: Dict[str, object] = {}
    for key, val in state.items():
        if key not in _KEYS:
            raise KeyError(f"unknown state key {key!r}")
        if key in ("init_params", "x0"):
            out[key] = arr(val)
        elif key in ("params_per_scale", "prev_params"):
            out[key] = [arr(t) for t in val]
        else:
            out[key] = tuple(arr(t) for t in val)
    return out
