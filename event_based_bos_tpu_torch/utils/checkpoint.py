"""Per-frame resumable results log (``resume: true``).

PyTorch port's copy of the JAX package's ``utils/checkpoint.py`` (numpy and
JSON only): a manifest mapping frame index → {timestamps, errors, flow
file}, rewritten atomically after every frame, so an interrupted evaluation
continues where it stopped.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["FrameResultStore"]


class FrameResultStore:
    MANIFEST = "frame_results.json"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.manifest_path = os.path.join(directory, self.MANIFEST)
        self._entries: Dict[str, dict] = {}
        if os.path.exists(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    self._entries = json.load(f)
                logger.info("Resuming: %d frames already computed.",
                            len(self._entries))
            except (json.JSONDecodeError, OSError):
                logger.warning("Corrupt manifest; starting fresh.")
                self._entries = {}

    def __contains__(self, frame_index: int) -> bool:
        return str(frame_index) in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, frame_index: int) -> Optional[dict]:
        return self._entries.get(str(frame_index))

    def load_flow(self, frame_index: int) -> Optional[np.ndarray]:
        entry = self.get(frame_index)
        if entry is None or "flow_file" not in entry:
            return None
        path = os.path.join(self.directory, entry["flow_file"])
        return np.load(path) if os.path.exists(path) else None

    def record(self, frame_index: int, flow: Optional[np.ndarray] = None,
               **metadata) -> None:
        """Record one frame's results and atomically rewrite the manifest."""
        entry = dict(metadata)
        if flow is not None:
            fname = f"flow_{frame_index:06d}.npy"
            np.save(os.path.join(self.directory, fname), np.asarray(flow))
            entry["flow_file"] = fname
        self._entries[str(frame_index)] = entry
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._entries, f)
            os.replace(tmp, self.manifest_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def summary(self) -> dict:
        """Aggregate statistics over the recorded error values."""
        keys = set()
        for e in self._entries.values():
            keys.update(k for k, v in e.items()
                        if isinstance(v, (int, float)))
        out = {}
        for k in keys:
            vals = np.asarray([e[k] for e in self._entries.values()
                               if k in e], float)
            if len(vals):
                out[k] = {"mean": float(vals.mean()),
                          "rms": float(np.sqrt((vals**2).mean())),
                          "std": float(vals.std()),
                          "min": float(vals.min()),
                          "max": float(vals.max()),
                          "n_data": int(len(vals))}
        return out
