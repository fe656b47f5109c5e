"""Profiling and timing: a fenced timing harness, ``torch.profiler``
traces, the program's spans and counters, and the section timer of the
evaluation loop (``profile: true``).

PyTorch port's counterpart of the JAX package's ``utils/tracing.py``.
``Timer`` times on the host wall clock and never waits for the card
itself: a section that must include device work ends in an explicit wait
(a fetch of its result, or ``torch.cuda.synchronize(device)``) written at
the call site.  ``timeit`` fences each call with ``device_fence``.

:func:`span` names a piece of the program's host work in a profiler's
trace (``ebt.filter``, ``ebt.encode``, ``ebt.upload``, ``ebt.estimate``,
``ebt.loop``, ``ebt.capture``, ``ebt.fetch``): the range lands in the same
trace as the device's kernels and copies, on the same clock, so each of the
device's idle gaps falls under the program's innermost span.  A span is
live exactly while a profiler records on the calling thread; otherwise it
is one check.  Spans come a few a frame and one a loop run, never inside a
captured graph nor per replay.  :func:`count` adds to a process-wide
counter at rare events (``graph.capture_s``, the seconds the graph
captures took); :func:`counters` reads them.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["device_fence", "timeit", "trace", "span", "count", "counters",
           "Timer"]

#: what :func:`span` returns while no profiler records
_NO_SPAN = contextlib.nullcontext()

_counters: Dict[str, Union[int, float]] = {}
_profiler_enabled = torch.autograd._profiler_enabled


def span(name: str):
    """A context that marks its block as ``name`` in the trace of the
    ``torch.profiler`` that records (``record_function``); while none
    does, the shared no-op context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, amount: Union[int, float] = 1) -> None:
    """Add ``amount`` to the process-wide counter ``name``."""
    _counters[name] = _counters.get(name, 0) + amount


def counters() -> Dict[str, Union[int, float]]:
    """A copy of the process-wide counters (absent until first counted)."""
    return dict(_counters)


def _array_leaves(tree) -> list:
    """The leaves of nested lists, tuples and dicts that have a ``dtype``
    (tensors, numpy arrays and scalars; dicts in sorted key order, as a JAX
    pytree flattens them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _array_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _array_leaves(item)]
    return [tree] if hasattr(tree, "dtype") else []


def device_fence(tree) -> float:
    """Wait for the device of the first leaf of ``tree`` that has a dtype
    and return that leaf's sum as a checksum (0.0 when ``tree`` holds no
    such leaf)."""
    leaves = _array_leaves(tree)
    if not leaves:
        return 0.0
    leaf = leaves[0]
    if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return float(leaf.sum())


def timeit(fn: Callable, *args, repeats: int = 5, warmup: int = 1,
           **kwargs) -> dict:
    """Fenced host wall clock of ``fn(*args, **kwargs)`` in seconds, with
    the fence's own cost measured and subtracted."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
        device_fence(out)
    t0 = time.perf_counter()
    for _ in range(3):
        device_fence(out)
    fence_s = (time.perf_counter() - t0) / 3
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        device_fence(out)
        times.append(time.perf_counter() - t0 - fence_s)
    arr = np.asarray(times)
    return {"median_s": float(np.median(arr)), "mean_s": float(arr.mean()),
            "min_s": float(arr.min()), "max_s": float(arr.max()),
            "fence_s": fence_s, "n": repeats}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity where CUDA is available) and export it as a Chrome trace
    ``trace_<pid>_<time>.json`` into ``log_dir`` (default
    ``<temp dir>/ebt_trace``); yields ``log_dir``.  Where the profiler
    cannot start, raises before the block runs: a trace asked for is never
    silently a run without one."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "ebt_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
    except Exception as e:
        raise RuntimeError(f"torch profiler could not start: {e}") from e
    try:
        yield log_dir
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


class Timer:
    """Accumulating host wall-clock section timer."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self, n_frames: Optional[int] = None,
               wall_s: Optional[float] = None) -> str:
        """The accumulated sections, largest first.

        With ``n_frames`` the values are per frame; with ``wall_s`` the
        percentages are shares of that wall-clock window (exposing untimed
        gaps) instead of shares of the recorded-section sum.  A nested
        section (``finalize/solve_wait``) runs inside its parent, so the
        sum counts only sections with no recorded ancestor.
        """
        def _has_parent(name):
            parts = name.split("/")
            return any("/".join(parts[:i]) in self.sections
                       for i in range(1, len(parts)))

        total = wall_s or sum(v for k, v in self.sections.items()
                              if not _has_parent(k)) or 1.0
        div = n_frames or 1
        unit = "s/frame" if n_frames else "s"
        return "\n".join(
            f"{k}: {v / div:.3f}{unit} ({100 * v / total:.1f}%)"
            for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]))
