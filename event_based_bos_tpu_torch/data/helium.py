"""HELIUM loader: frame-only ``.tif`` sequences at 1000 fps.

PyTorch port's copy of the JAX package's ``data/helium.py``, host-only:
the alphabetically last ``.tif`` of the sequence is the undistorted
background; index 0 loads it at t = 0 and index i ≥ 1 loads target frame
i − 1 at ``i / fps``.  There are no events.  ``cv2`` is imported only
where an image is decoded.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Tuple

import numpy as np

from .base import DataLoaderBase

logger = logging.getLogger(__name__)

__all__ = ["HeliumDataLoader"]


class HeliumDataLoader(DataLoaderBase):
    NAME = "HELIUM"

    def __init__(self, config=None):
        super().__init__(config)
        self.fps = 1000.0

    def get_sequence(self, sequence_name: str) -> dict:
        data_path = os.path.join(self.dataset_dir, sequence_name)
        images = sorted(glob.glob(os.path.join(data_path, "*.tif")))
        return {"background_image": images[-1], "target_image": images[:-1]}

    def __len__(self):
        return self.num_images

    @property
    def num_images(self):
        return len(self.dataset_files["target_image"])

    def load_event(self, start_index, end_index, *a, **k) -> np.ndarray:
        raise NotImplementedError("This dataset has no events.")

    def load_image(self, index: int) -> Tuple[np.ndarray, float]:
        import cv2

        if index == 0:
            img = cv2.imread(self.dataset_files["background_image"],
                             cv2.IMREAD_GRAYSCALE)
            return img, 0.0
        img = cv2.imread(self.dataset_files["target_image"][index - 1],
                         cv2.IMREAD_GRAYSCALE)
        return img, index / self.fps

    def time_to_image_index(self, time: float) -> int:
        return int(time * self.fps)

    def image_index_to_time(self, index: int) -> float:
        return index / self.fps

    def load_calib(self) -> dict:
        return {"K": None, "D": None}
