"""E2VID loader: frames reconstructed from events (a PNG directory with
``timestamps.txt``).

PyTorch port's copy of the JAX package's ``data/e2vid.py``, host-only: a
sequence is ``<root>/<dataset>/<sequence>/`` with the reconstructions as
``*.png`` (sorted by name), their times in ``timestamps.txt``, and an
optional comma-separated event list ``events.csv`` (rows ``x,y,p,t``)
whose 4th column is read only for :func:`len`.  ``time_to_index`` indexes
the *images* (the last one at or before the time, −1 before the first).
``cv2`` is imported only where a PNG is decoded.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Tuple

import numpy as np

from .base import DataLoaderBase

logger = logging.getLogger(__name__)

__all__ = ["E2vidDataLoader"]


class E2vidDataLoader(DataLoaderBase):
    NAME = "E2VID"

    def __init__(self, config=None, overwrite_dataset: bool = False):
        super().__init__(config)
        self._time_cache = None
        self._image_cache = None
        self._do_overwrite_dataset = overwrite_dataset

    def get_sequence(self, sequence_name: str) -> dict:
        if self._do_overwrite_dataset:
            head, _tail = os.path.split(self.dataset_dir)
            self.dataset_dir = os.path.join(head, "E2VID")
        data_path = os.path.join(self.dataset_dir, sequence_name)
        return {
            "frame": data_path,
            "timestamp": os.path.join(data_path, "timestamps.txt"),
            "event": os.path.join(data_path, "events.csv"),
        }

    def __len__(self):
        self._ensure_time_cache()
        return len(self._time_cache) - 1

    def _ensure_time_cache(self):
        if self._time_cache is not None:
            return
        # rows x,y,p,t: the timestamps are the 4th column
        ts = []
        with open(self.dataset_files["event"]) as f:
            for line in f:
                ts.append(np.float64(line.split(",")[3]))
        self._time_cache = np.asarray(ts)

    def _ensure_image_cache(self):
        if self._image_cache is not None:
            return
        files = sorted(glob.glob(os.path.join(self.dataset_files["frame"],
                                              "*.png")))
        timestamps = np.loadtxt(self.dataset_files["timestamp"], dtype=float)
        self._image_cache = {"image": files, "timestamp": timestamps}

    @property
    def num_images(self):
        self._ensure_image_cache()
        return len(self._image_cache["image"])

    def time_to_index(self, time: float) -> int:
        self._ensure_image_cache()
        return int(np.searchsorted(self._image_cache["timestamp"], time)) - 1

    time_to_image_index = time_to_index

    def image_index_to_time(self, index: int) -> float:
        self._ensure_image_cache()
        return float(self._image_cache["timestamp"][index])

    def load_image(self, index: int) -> Tuple[np.ndarray, float]:
        import cv2

        self._ensure_image_cache()
        if index >= self.num_images:
            raise IndexError(f"image {index} of {self.num_images}")
        image = cv2.imread(self._image_cache["image"][index],
                           cv2.IMREAD_GRAYSCALE)
        return image, float(self._image_cache["timestamp"][index])

    def load_calib(self) -> dict:
        return {"K": None, "D": None}
