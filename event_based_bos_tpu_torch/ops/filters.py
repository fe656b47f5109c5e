"""The configured event preprocessing pipeline (``solver.filter``).

PyTorch counterpart of the JAX package's ``ops/filters.py::EventFilter``:
the filter list comes from the YAML ``solver.filter`` section, and a CROP
pass is prepended when an ROI is configured (``utils/config.py::
propagate_config`` always configures one).  Both shipped configs run the
CROP pass alone.  The background-activity (``BAF``) and hot-pixel
(``HOT``) filters need the native runtime or the device BAF kernels and
raise ``NotImplementedError`` until ROADMAP Queue 1 #14 ports them.
"""

from __future__ import annotations

import numpy as np

from ..types import Events
from .events import crop_event

__all__ = ["EventFilter"]

_NOT_PORTED = ("BAF", "HOT")


class EventFilter:
    """CROP → BAF → HOT, as configured."""

    def __init__(self, image_shape, filter_config):
        self.image_shape = tuple(image_shape)
        self.params = filter_config.get("parameters", {})
        self.filters = list(filter_config.get("filters") or [])
        if "xmin" in self.params:
            self.filters = ["CROP"] + self.filters
        for name in self.filters:
            if name in _NOT_PORTED:
                raise NotImplementedError(
                    f"the {name} event filter is not ported yet (ROADMAP "
                    f"Queue 1 #14); the port runs the CROP pass")
            if name != "CROP":
                raise KeyError(f"Unknown filter {name!r}")

    def process_numpy(self, events: np.ndarray) -> np.ndarray:
        """The pipeline over a raw ``(n, 4)`` host array (before the
        upload); returns the filtered array."""
        for _name in self.filters:
            if len(events) < 10:
                return events
            m = ((events[:, 0] >= self.params["xmin"])
                 & (events[:, 0] < self.params["xmax"])
                 & (events[:, 1] >= self.params["ymin"])
                 & (events[:, 1] < self.params["ymax"]))
            events = events[m]
        return events

    def process(self, ev: Events) -> Events:
        """The pipeline over an uploaded batch (a validity-mask update)."""
        for _name in self.filters:
            if int(ev.count()) < 10:
                return ev
            ev = crop_event(ev, self.params["xmin"], self.params["xmax"],
                            self.params["ymin"], self.params["ymax"])
        return ev
