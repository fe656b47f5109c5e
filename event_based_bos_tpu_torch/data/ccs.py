"""Co-Capture System (CCS) loader: Prophesee events + Basler mp4 frames.

The port's copy of the JAX package's ``data/ccs.py``:

  * sequence layout ``<seq>/prophesee_0/{events.hdf5 | cd_events.raw,
    trigger_events.txt, roi.csv}``, ``<seq>/basler_0/frames.mp4``,
    ``<seq>/homography.txt``, ``<seq>/thermal/*.csv``;
  * events from the HDF5 stream (``h5py``, imported only there) or, where
    no HDF5 file exists, from the raw EVT3 capture through the native
    decoder (:func:`event_based_bos_tpu_torch.runtime.decode_evt3`); they
    load with **x/y swapped** (the stream's x is the sensor column, the
    pipeline's x the row) and µs → s;
  * the mp4 frames extracted once into a ``frames/`` png cache, their
    timestamps from the trigger's positive edges (both text formats);
  * with ``warp: true`` the frames warped into the event camera's plane by
    the recording's homography (``cv2`` imported there);
  * ``time_to_index`` = searchsorted − 1 over the int32 µs stream through
    the native runtime;
  * :meth:`CcsDataLoader.load_event_batch` extracts a padded window
    natively and returns the port's :class:`Events` on the device the
    caller names.
"""

from __future__ import annotations

import glob
import logging
import math
import os
import pathlib
from typing import Optional, Tuple

import numpy as np
import torch

from .. import runtime
from ..device import resolve_device
from ..types import Events
from ..utils.video import extract_mp4
from .base import DataLoaderBase

logger = logging.getLogger(__name__)

__all__ = ["CcsDataLoader", "load_frame_timestamps", "h5py_loader"]

IMG_FORMATS = ("bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff",
               "webp")


def load_frame_timestamps(path: str) -> np.ndarray:
    """Positive-edge trigger timestamps (µs), in either Metavision text
    format (``t, id, edge`` or ``edge, id, t`` comma-separated)."""
    try:
        arr = np.loadtxt(path, dtype=int)
        arr = arr[arr[:, 2] == 1]
        return arr[:, 0]
    except ValueError:
        logger.warning("Trying comma-separated trigger format…")
        arr = np.loadtxt(path, dtype=int, delimiter=",")
        arr = arr[arr[:, 0] == 1]
        return arr[:, 2]


def h5py_loader(path: str) -> dict:
    """The whole ``raw_events/{x,y,t,p}`` stream of an HDF5 recording."""
    import h5py

    try:  # optional compression plugin
        import hdf5plugin  # noqa: F401
    except ImportError:
        pass
    with h5py.File(path, "r") as f:
        if len(f["raw_events"]["t"]) > np.iinfo(np.int32).max:
            logger.warning("Event count exceeds int32 — check dtypes.")
        return {
            "x": np.asarray(f["raw_events"]["x"], np.int16),
            "y": np.asarray(f["raw_events"]["y"], np.int16),
            "t": np.asarray(f["raw_events"]["t"], np.int32),
            "p": np.asarray(f["raw_events"]["p"], bool),
        }


class CcsDataLoader(DataLoaderBase):
    NAME = "CCS"

    def __init__(self, config=None):
        super().__init__(config)
        self._time_cache = None
        self._image_cache = None
        self.warp_frame = bool((config or {}).get("warp"))
        self.crop_info = None
        #: "hdf5" or "evt3": where the events of the sequence came from
        self.event_source = None

    def __len__(self):
        return len(self.event_data["x"])

    @property
    def num_images(self):
        self._ensure_image_cache()
        return len(self._image_cache["image"])

    @property
    def num_thermals(self):
        return len(self.dataset_files.get("thermal", []))

    def get_sequence(self, sequence_name: str) -> dict:
        seq = os.path.join(self.dataset_dir, sequence_name)
        ev_dir = os.path.join(seq, "prophesee_0")
        return {
            "event_raw": os.path.join(ev_dir, "cd_events.raw"),
            "event_hdf": os.path.join(ev_dir, "events.hdf5"),
            "event_csv": os.path.join(ev_dir, "cd.csv"),
            "event_trigger": os.path.join(ev_dir, "trigger_events.txt"),
            "event_roi": os.path.join(ev_dir, "roi.csv"),
            "frame": os.path.join(seq, "basler_0", "frames.mp4"),
            "frame_2x": os.path.join(seq, "basler_0",
                                     "frames_2X_240fps.mp4"),
            "homography": os.path.join(seq, "homography.txt"),
            "thermal": sorted(glob.glob(os.path.join(seq, "thermal",
                                                     "*.csv"))),
        }

    def set_sequence(self, sequence_name: str, undistort: bool = False
                     ) -> None:
        super().set_sequence(sequence_name)
        hdf = self.dataset_files["event_hdf"]
        raw = self.dataset_files["event_raw"]
        if os.path.exists(hdf):
            self.event_data = h5py_loader(hdf)
            self.event_source = "hdf5"
        elif os.path.exists(raw):
            with open(raw, "rb") as f:
                self.event_data = runtime.decode_evt3(f.read())
            self.event_source = "evt3"
            logger.info("Decoded %d events from EVT3 capture %s",
                        len(self.event_data["x"]), raw)
        else:
            raise FileNotFoundError(
                f"No event source for sequence {sequence_name!r}: neither "
                f"{hdf} nor {raw} exists.")
        self.min_ts = self.event_data["t"].min() / 1e6
        self.max_ts = self.event_data["t"].max() / 1e6
        self.data_duration = self.max_ts - self.min_ts
        self._time_cache = self.event_data["t"] / 1e6
        roi_file = self.dataset_files["event_roi"]
        if os.path.exists(roi_file):
            try:
                self.crop_info = self.load_recording_cropinfo(roi_file)
            except Exception:  # noqa: BLE001
                logger.warning("Failed to load the recording ROI info.")

    def load_recording_cropinfo(self, csv_file: str) -> np.ndarray:
        """ROI rows ``[y0, x0, width, height]`` → ``[x0, x1, y0, y1]``."""
        rois = np.loadtxt(csv_file, delimiter=",")
        if rois.ndim == 1:
            rois = rois[None]
        out = np.zeros_like(rois)
        out[:, 0] = rois[:, 1]
        out[:, 1] = rois[:, 1] + rois[:, 3]
        out[:, 2] = rois[:, 0]
        out[:, 3] = rois[:, 0] + rois[:, 2]
        return out

    # -- events ---------------------------------------------------------------
    def load_event(self, start_index: int, end_index: int, *a, **k
                   ) -> np.ndarray:
        if end_index > len(self) or start_index >= len(self):
            raise IndexError(
                f"Specified {start_index}:{end_index} of {len(self)} events.")
        n = end_index - start_index
        out = np.zeros((n, 4), np.float64)
        out[:, 0] = self.event_data["y"][start_index:end_index]  # row
        out[:, 1] = self.event_data["x"][start_index:end_index]  # col
        out[:, 2] = self.event_data["t"][start_index:end_index] / 1e6
        out[:, 3] = self.event_data["p"][start_index:end_index]
        if out.shape[0] == 0:
            raise IndexError("No events in the requested range.")
        return out

    def index_to_time(self, index: int) -> float:
        return float(self._time_cache[index])

    def time_to_index(self, time: float) -> int:
        # the first integer µs >= time·1e6 gives the same index as a
        # searchsorted over the float seconds
        return runtime.searchsorted(self.event_data["t"],
                                    int(math.ceil(time * 1e6 - 1e-6))) - 1

    def load_event_batch(self, start_index: int, end_index: int,
                         capacity: int, dtype: Optional[torch.dtype] = None,
                         device=None) -> Events:
        """Events ``[start_index, end_index)`` padded to ``capacity``,
        extracted from the raw stream by the native runtime, on ``device``
        (the GPU unless the caller asks for another)."""
        p = self.event_data["p"]
        if p.dtype != np.uint8:
            p = p.astype(np.uint8)
            self.event_data["p"] = p
        x, y, t, p5, valid, _n = runtime.window_padded(
            self.event_data["x"], self.event_data["y"], self.event_data["t"],
            p, start_index, end_index, capacity)
        dev = resolve_device(device)
        dt = dtype or torch.float32
        return Events(*(torch.as_tensor(a).to(device=dev, dtype=dt)
                        for a in (x, y, t, p5)),
                      torch.as_tensor(valid.astype(bool)).to(dev))

    # -- frames ---------------------------------------------------------------
    def _ensure_image_cache(self):
        if self._image_cache is not None:
            return
        data_path = self.dataset_files["frame"]
        frame_dir = os.path.join(str(pathlib.Path(data_path).parents[0]),
                                 "frames")
        if (pathlib.Path(data_path).suffix == ".mp4"
                and not os.path.isdir(frame_dir)):
            pathlib.Path(frame_dir).mkdir()
            extract_mp4(data_path, frame_dir)
        files = sorted(glob.glob(os.path.join(frame_dir, "*.*")))
        images = [x for x in files
                  if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS]
        timestamps = load_frame_timestamps(
            self.dataset_files["event_trigger"]) / 1e6
        self._image_cache = {"image": images, "timestamp": timestamps}
        if self.warp_frame:
            self._image_cache["homography"] = np.loadtxt(
                self.dataset_files["homography"])
        logger.info("Num images %d", len(images))

    def image_index_to_time(self, index: int) -> float:
        self._ensure_image_cache()
        return float(self._image_cache["timestamp"][index])

    def time_to_image_index(self, time: float) -> int:
        self._ensure_image_cache()
        return int(np.searchsorted(self._image_cache["timestamp"], time)) - 1

    def load_image(self, index: int) -> Tuple[np.ndarray, float]:
        import cv2

        self._ensure_image_cache()
        assert index < self.num_images
        image = cv2.imread(self._image_cache["image"][index],
                           cv2.IMREAD_GRAYSCALE)
        ts = float(self._image_cache["timestamp"][index])
        if self.warp_frame:
            image = cv2.warpPerspective(
                image, self._image_cache["homography"],
                (self._WIDTH, self._HEIGHT))
        return image, ts

    # -- thermal ----------------------------------------------------------------
    def load_thermal(self, index: int) -> np.ndarray:
        """One CSV thermal frame."""
        assert index < self.num_thermals
        rows = []
        with open(self.dataset_files["thermal"][index]) as f:
            for line in f:
                vals = [float(v) for v in line.split(",")
                        if v.strip() not in ("", "\n")]
                if vals:
                    rows.append(vals)
        arr = np.asarray(rows)
        assert arr.ndim == 2
        return arr

    def load_calib(self) -> dict:
        return {"K": None, "D": None}
