"""Optimizer loops as replayed CUDA graphs.

The JAX package runs a first-order solve as one ``lax.scan`` under
``jax.jit``: the step is compiled once and the loop never returns to the
host.  The port's counterpart is a CUDA graph of one optimizer step,
captured once and replayed for the remaining steps (:class:`StepGraph`).
The step must keep every piece of loop state in tensors allocated before
it runs and read everything that changes from step to step from the
device (``optim.py``'s step tables and step counter), so that one captured
step serves every index.

On a CUDA device every first-order loop takes this route
(:func:`graph_route`).  Inside :func:`eager_loops` (the counterpart of
``jax.disable_jit()``) the same step is dispatched op by op instead; the
comparisons of the two routes and the tests use it.  So it is under
autograd's anomaly mode (``debug_nans``), which reads every backward's
output on the host.  On the CPU the step runs in a Python loop.  A capture
that fails raises: nothing falls back to the eager route.

The graph route on the card:

* the step runs eagerly :data:`WARMUP_STEPS` times on a side stream (real
  steps of the solve: they also build the libraries' lazy state, such as
  cuBLAS workspaces, outside the capture);
* one step is captured on that stream into a private memory pool, with
  ``capture_error_mode="thread_local"``, so that the pipelined loop's
  prefetch thread and the visualizer's writer thread may keep using the
  card meanwhile; the capture records the step but does not run it, so the
  captured step is replayed for its own index too;
* the graph is replayed for every remaining step, and for every step of a
  later run of the same loop (a reused solve program).

The launches of the port's kernels that a captured step makes are counted
once per replay (:func:`event_based_bos_tpu_torch.kernels.recording`).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from . import kernels

__all__ = ["WARMUP_STEPS", "eager_loops", "graph_route", "StepGraph"]

#: eager steps on the side stream before the capture
WARMUP_STEPS = 2

_eager_depth = 0


@contextlib.contextmanager
def eager_loops() -> Iterator[None]:
    """Inside the block, the optimizer loops on the card dispatch their step
    op by op instead of replaying a graph of it: the same arithmetic, for
    comparisons with the graph route."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def graph_route(device: torch.device) -> bool:
    """Whether a loop on ``device`` runs as a replayed graph: on a CUDA
    device, outside :func:`eager_loops` and outside autograd's anomaly mode
    (``debug_nans``), whose NaN check reads every backward's output on the
    host."""
    return (device.type == "cuda" and _eager_depth == 0
            and not torch.is_anomaly_enabled())


class _Captured:
    """A captured step on the card: the CUDA graph and its memory pool."""

    def __init__(self, step: Callable[[], None], device: torch.device):
        self.graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        before = torch.cuda.memory_reserved(device)
        # The collector stays off while the step is captured: collecting a
        # dead loop there would destroy its graph, a call that ends the
        # capture.  (``torch.cuda.graph`` would also synchronize the device
        # and empty the allocator's cache first; the capture needs neither.)
        collecting = gc.isenabled()
        gc.disable()
        try:
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                step()
            except BaseException:
                with contextlib.suppress(Exception):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes = torch.cuda.memory_reserved(device) - before

    def replay(self) -> None:
        self.graph.replay()


def _capture(step: Callable[[], None], device: torch.device):
    """Capture one ``step()``; returns an object with ``replay()`` and
    ``pool_bytes``."""
    return _Captured(step, device)


class StepGraph:
    """Runs a step function ``n`` times at a time on the graph route.

    The first :meth:`run` warms up, captures and replays; later runs
    replay only.  The step takes no arguments and returns nothing: it reads
    and writes the loop's state in place, and the caller copies the
    outputs out of that state after the run (a later run overwrites it).
    ``capture_ms`` and ``pool_bytes`` describe the capture, ``launches``
    the port's kernel launches of one replay.
    """

    def __init__(self, step: Callable[[], None], device: torch.device):
        self.step = step
        self.device = device
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.capture_ms: Optional[float] = None
        self.pool_bytes = 0
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def _on_side_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def run(self, n: int) -> None:
        """``n`` steps, queued behind the current stream's work; the current
        stream waits for them."""
        if n <= 0:
            return
        current = (torch.cuda.current_stream(self.device)
                   if self._stream is not None else None)
        if current is not None:
            self._stream.wait_stream(current)
        with self._on_side_stream():
            done = 0
            if self.graph is None:
                done = min(n, WARMUP_STEPS)
                for _ in range(done):
                    self.step()
                if done < n:
                    self._capture()
            for _ in range(n - done):
                self.graph.replay()
                for name, k in self.launches.items():
                    kernels.launches[name] += k
        if current is not None:
            current.wait_stream(self._stream)

    def _capture(self) -> None:
        if self.device.type == "cuda":
            # a kernel wrapper's first call inside the capture would build
            # and load the library
            kernels.library()
        t0 = time.perf_counter()
        with kernels.recording() as tally:
            self.graph = _capture(self.step, self.device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.launches = dict(tally)
        self.pool_bytes = self.graph.pool_bytes
