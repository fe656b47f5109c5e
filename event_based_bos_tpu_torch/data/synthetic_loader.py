"""In-memory synthetic BOS recording exposed through the loader contract.

PyTorch port's copy of the JAX package's ``data/synthetic_loader.py``: the
simulator of :mod:`event_based_bos_tpu_torch.data.synthetic` behind the
loader API, so the CLI's evaluation loop runs without a recorded dataset,
with the *true* ground-truth flow available via :meth:`load_optical_flow`.

The sequence name selects the seed (``"plume0"`` → 0, ``"plume7"`` → 7).
Generation parameters come from the ``data`` config section (``height``,
``width``, ``duration``, ``fps``, ``events_per_frame``,
``max_displacement``).
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from .base import DataLoaderBase
from .synthetic import SyntheticBosConfig, generate_sequence

__all__ = ["SyntheticDataLoader"]


class SyntheticDataLoader(DataLoaderBase):
    NAME = "SYNTHETIC"

    def __init__(self, config=None):
        super().__init__(config)
        self._seq = None

    def get_sequence(self, sequence_name: str) -> dict:
        return {"name": sequence_name}

    def set_sequence(self, sequence_name: str, undistort: bool = False
                     ) -> None:
        super().set_sequence(sequence_name)
        m = re.search(r"(\d+)$", sequence_name)
        seed = int(m.group(1)) if m else 0
        c = self.config
        cfg = SyntheticBosConfig(
            height=c.get("height", 240),
            width=c.get("width", 320),
            duration=float(c.get("duration", 1.0)),
            fps=float(c.get("fps", 60.0)),
            events_per_frame=int(c.get("events_per_frame", 40_000)),
            max_displacement=float(c.get("max_displacement", 2.0)),
            seed=seed,
        )
        self._seq = generate_sequence(cfg)
        self.min_ts = float(self._seq["events"][0, 2])
        self.max_ts = float(self._seq["events"][-1, 2])
        self.data_duration = self.max_ts - self.min_ts

    def __len__(self):
        return len(self._seq["events"])

    @property
    def num_images(self):
        return len(self._seq["frames"])

    def load_event(self, start_index: int, end_index: int, *a, **k
                   ) -> np.ndarray:
        if end_index > len(self) or start_index >= len(self):
            raise IndexError(
                f"Specified {start_index}:{end_index} of {len(self)} events.")
        return self._seq["events"][start_index:end_index].copy()

    def load_image(self, index: int) -> Tuple[np.ndarray, float]:
        if index >= self.num_images:
            raise IndexError(f"image {index} of {self.num_images}")
        return (self._seq["frames"][index].copy(),
                float(self._seq["frame_ts"][index]))

    def load_optical_flow(self, frame_index: int, *a, **k) -> np.ndarray:
        """True inter-frame pattern displacement ``[2, H, W]`` (row, col)
        from image ``frame_index`` to the next."""
        return self._seq["gt_flow"][frame_index].copy()

    def index_to_time(self, index: int) -> float:
        return float(self._seq["events"][index, 2])

    def time_to_index(self, time: float) -> int:
        return int(np.searchsorted(self._seq["events"][:, 2], time)) - 1

    def time_to_image_index(self, time: float) -> int:
        return int(np.searchsorted(self._seq["frame_ts"], time)) - 1

    def image_index_to_time(self, index: int) -> float:
        return float(self._seq["frame_ts"][index])
