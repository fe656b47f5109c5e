"""Frozen scene generators, one module each, found by the name a traffic
file gives under ``scene``.

A scene module has ``make_windows(image_size, n_windows, n_events, params,
seed)``, which returns ``n_windows`` :class:`Window` objects made from
``seed`` alone: the same seed gives the same arrays.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Window:
    """One window of traffic: ``events`` ``(n, 4)`` float64 rows of
    ``(row, col, t, p)`` at integer pixel positions; ``frame`` the model
    frame ``[H, W]`` float32 (None for events-only scenes); ``true_flow``
    the pattern displacement over the window ``[2, H, W]`` float32."""

    events: np.ndarray
    frame: Optional[np.ndarray]
    true_flow: np.ndarray


def load(name: str):
    """The scene module ``perfbench.scenes.<name>``."""
    return importlib.import_module(f"{__name__}.{name}")
