"""The configured event preprocessing pipeline (``solver.filter``).

PyTorch counterpart of the JAX package's ``ops/filters.py::EventFilter``:
the filter list comes from the YAML ``solver.filter`` section, and a CROP
pass is prepended when an ROI is configured (``utils/config.py::
propagate_config`` always configures one).  On the host
(:meth:`EventFilter.process_numpy`, which the evaluation loops run before
the upload) every pass runs: CROP, and the exact background-activity
(``BAF``) and hot-pixel (``HOT``) filters through the port's native
runtime (:mod:`event_based_bos_tpu_torch.runtime`), with
``BAF_continuous_update`` carrying the BAF time map across windows.  On
the device (:meth:`EventFilter.process`) only CROP is ported; the device
BAF and HOT raise ``NotImplementedError`` until ROADMAP Queue 1 #14b.
"""

from __future__ import annotations

import numpy as np

from .. import runtime
from ..types import Events
from .events import crop_event

__all__ = ["EventFilter"]

_KNOWN = ("CROP", "BAF", "HOT")


class EventFilter:
    """CROP → BAF → HOT, as configured."""

    def __init__(self, image_shape, filter_config):
        self.image_shape = tuple(image_shape)
        self.params = filter_config.get("parameters", {})
        self.filters = list(filter_config.get("filters") or [])
        if "xmin" in self.params:
            self.filters = ["CROP"] + self.filters
        for name in self.filters:
            if name not in _KNOWN:
                raise KeyError(f"Unknown filter {name!r}")
        self.continuous_update = bool(self.params.get("BAF_continuous_update"))
        #: the BAF's latest-time map, carried across windows with
        #: ``BAF_continuous_update``
        self.np_time_map = None

    def process_numpy(self, events: np.ndarray) -> np.ndarray:
        """The pipeline over a raw ``(n, 4)`` host array (before the
        upload); returns the filtered array."""
        for name in self.filters:
            if len(events) < 10:
                return events
            if name == "CROP":
                m = ((events[:, 0] >= self.params["xmin"])
                     & (events[:, 0] < self.params["xmax"])
                     & (events[:, 1] >= self.params["ymin"])
                     & (events[:, 1] < self.params["ymax"]))
                events = events[m]
            elif name == "BAF":
                keep, tmap = runtime.baf_filter(
                    events, self.image_shape, self.params["BAF_dt"],
                    self.params.get("BAF_ksize", 1),
                    self.params.get("BAF_num_support_event", 1),
                    time_map=self.np_time_map)
                self.np_time_map = tmap if self.continuous_update else None
                events = events[keep]
            else:
                keep = runtime.hot_pixel_filter(
                    events, self.image_shape,
                    self.params.get("HOT_thresh", 10))
                events = events[keep]
        return events

    def process(self, ev: Events) -> Events:
        """The pipeline over an uploaded batch (a validity-mask update)."""
        for name in self.filters:
            if name != "CROP":
                raise NotImplementedError(
                    f"the device {name} filter is not ported yet (ROADMAP "
                    "Queue 1 #14b); filter the (n, 4) host array with "
                    "process_numpy before the upload")
        for _name in self.filters:
            if int(ev.count()) < 10:
                return ev
            ev = crop_event(ev, self.params["xmin"], self.params["xmax"],
                            self.params["ymin"], self.params["ymax"])
        return ev
