"""Video IO helpers: mp4 frame extraction, an mp4 writer and side-by-side
concatenation, on ``cv2.VideoWriter`` (no ffmpeg binary is needed).

The port's own copy of the JAX package's ``utils/video.py``.  ``cv2`` is
imported only inside the functions; where no mp4 codec is available the
writers log a warning and write nothing.
"""

from __future__ import annotations

import logging
import os
import pathlib
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["extract_mp4", "write_video", "concat_videos_horizontally"]


def extract_mp4(mp4_path: str, path_frame_dir: str) -> int:
    """Dump every frame of an mp4 into numbered pngs; returns the frame
    count."""
    import cv2

    cap = cv2.VideoCapture(mp4_path)
    if not os.path.isdir(path_frame_dir):
        pathlib.Path(path_frame_dir).mkdir(parents=True)
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        cv2.imwrite(os.path.join(path_frame_dir, f"{idx:010d}.png"), frame)
        idx += 1
    cap.release()
    return idx


def write_video(image_files: List[str], out_path: str, fps: float = 20.0) -> Optional[str]:
    """Encode a sorted list of image files into an mp4 (cv2.VideoWriter)."""
    import cv2

    if not image_files:
        logger.warning("No frames for video %s", out_path)
        return None
    first = cv2.imread(image_files[0])
    if first is None:
        logger.warning("Unreadable frame %s", image_files[0])
        return None
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        logger.warning("No mp4 codec available; skipping video %s", out_path)
        return None
    for f in image_files:
        img = cv2.imread(f)
        if img is None:
            continue
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h))
        writer.write(img)
    writer.release()
    return out_path


def concat_videos_horizontally(video_paths: List[str], out_path: str,
                               labels: Optional[List[str]] = None,
                               fps: float = 20.0) -> Optional[str]:
    """Side-by-side concatenation of ``video_paths`` (scaled to the
    smallest height) with optional text labels."""
    import cv2

    caps = [cv2.VideoCapture(p) for p in video_paths]
    if not caps or not all(c.isOpened() for c in caps):
        logger.warning("Cannot open all videos for concat: %s", video_paths)
        for c in caps:
            c.release()
        return None
    h = int(min(c.get(cv2.CAP_PROP_FRAME_HEIGHT) for c in caps))
    writer = None
    while True:
        frames = []
        for c in caps:
            ok, fr = c.read()
            if not ok:
                frames = None
                break
            scale = h / fr.shape[0]
            fr = cv2.resize(fr, (int(fr.shape[1] * scale), h))
            frames.append(fr)
        if frames is None:
            break
        row = np.concatenate(frames, axis=1)
        if labels:
            x = 10
            for lab, fr in zip(labels, frames):
                cv2.putText(row, lab, (x, 30), cv2.FONT_HERSHEY_SIMPLEX, 1,
                            (255, 255, 255), 2)
                x += fr.shape[1]
        if writer is None:
            writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (row.shape[1], row.shape[0]))
            if not writer.isOpened():
                logger.warning("No mp4 codec; skipping concat %s", out_path)
                break
        writer.write(row)
    for c in caps:
        c.release()
    if writer is not None:
        writer.release()
        return out_path
    return None
