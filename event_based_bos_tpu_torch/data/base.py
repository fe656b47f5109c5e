"""Dataset loader contract.

PyTorch port's copy of the JAX package's ``data/base.py``: the host-side
I/O API (``set_sequence`` / ``load_event`` / ``load_image`` /
``load_calib`` / ``index_to_time`` / ``time_to_index``), plus
:meth:`DataLoaderBase.load_event_batch`, which returns a fixed-capacity
:class:`~event_based_bos_tpu_torch.types.Events` on a device the caller
names.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..types import Events, events_from_ndarray

logger = logging.getLogger(__name__)

__all__ = ["DATASET_ROOT_DIR", "DataLoaderBase"]

DATASET_ROOT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "datasets",
)


class DataLoaderBase:
    NAME = "example"

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self._HEIGHT = config.get("height")
        self._WIDTH = config.get("width")
        root = config.get("root") or DATASET_ROOT_DIR
        self.root_dir = os.path.expanduser(root)
        data_dir = config.get("dataset") or self.NAME
        self.dataset_dir = os.path.join(self.root_dir, data_dir)
        self.dataset_files: dict = {}
        self.auto_undistort = bool(config.get("undistort"))
        self.config = config

    # -- sequence management -------------------------------------------------
    def set_sequence(self, sequence_name: str) -> None:
        logger.info("Use sequence %s", sequence_name)
        self.sequence_name = sequence_name
        self.dataset_files = self.get_sequence(sequence_name)

    def get_sequence(self, sequence_name: str) -> dict:
        raise NotImplementedError

    # -- raw access ------------------------------------------------------------
    def load_event(self, start_index: int, end_index: int, *a, **k
                   ) -> np.ndarray:
        """Return ``(n, 4)`` float64 ``(x=row, y=col, t sec, p)``."""
        raise NotImplementedError

    def load_image(self, index: int) -> Tuple[np.ndarray, float]:
        raise NotImplementedError

    def load_calib(self) -> dict:
        return {"K": None, "D": None}

    def load_optical_flow(self, t1: float, t2: float, *a, **k) -> np.ndarray:
        raise NotImplementedError

    def index_to_time(self, index: int) -> float:
        raise NotImplementedError

    def time_to_index(self, time: float) -> int:
        raise NotImplementedError

    def time_to_image_index(self, time: float) -> int:
        raise NotImplementedError

    def image_index_to_time(self, index: int) -> float:
        raise NotImplementedError

    # -- device access -----------------------------------------------------------
    def load_event_batch(self, start_index: int, end_index: int,
                         capacity: int, dtype: Optional[torch.dtype] = None,
                         device=None) -> Events:
        """A padded fixed-capacity batch on ``device`` (the GPU unless the
        caller asks for another)."""
        arr = self.load_event(start_index, end_index)
        return events_from_ndarray(arr, capacity=capacity,
                                   dtype=dtype or torch.float32,
                                   device=device)
