"""Optimizer loops and per-frame programs as replayed CUDA graphs.

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

A loop whose iteration holds a loop of its own, decided by the data (the
zoom line search inside an L-BFGS iteration, a ``lax.while_loop`` inside
the JAX package's ``lax.scan``), runs as a :class:`WhileGraph`: three
captured parts, ``pre``, ``body`` and ``post``, assembled by
``csrc/graph_while.cu`` into one graph whose conditional WHILE node repeats
``body`` until a device flag is set.  One iteration is one launch of that
graph, with no read to the host.

Two more pieces keep a frame's work from frame to frame, as the JAX
package keeps one ``jax.jit`` program per shape:

* :class:`CapturedProgram` captures a whole function of tensors (the IWE
  cache, CMax's histograms, the per-frame evaluation programs): its first
  call with a signature runs it eagerly on buffers of its own and captures
  it, every later call copies its arguments into the buffers, replays and
  returns copies of the outputs;
* :class:`KeptSolve` holds a solve's per-frame constants in buffers of its
  own and the solve's loops over them (each loop's step a
  :class:`StepGraph`, L-BFGS's iteration a :class:`WhileGraph`, a
  sampler's trials a :class:`CapturedProgram`), and the interpolation
  matrices between scales: the solve programs of the pyramid, CMax, GML
  and the tiled solvers.

Whatever a captured graph reads stays alive while the graph does: its
buffers, the loops' state, and the operators it was built with (the
caches of ``ops/iwe.py`` and ``ops/poisson.py`` never drop an entry).
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from . import kernels

__all__ = ["WARMUP_STEPS", "eager_loops", "graph_route", "StepGraph",
           "WhileGraph", "CapturedProgram", "KeptSolve"]

#: eager steps on the side stream before the capture
WARMUP_STEPS = 2

_eager_depth = 0


@contextlib.contextmanager
def eager_loops() -> Iterator[None]:
    """Inside the block, the optimizer loops and the kept programs on the
    card dispatch their work op by op instead of replaying a graph of it:
    the same arithmetic, for comparisons with the graph route."""
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


def _recorded_capture(step: Callable[[], None], device: torch.device):
    """:func:`_capture` with the port's kernel launches that ``step`` makes
    recorded: returns ``(graph, launches a replay, capture ms)``."""
    if device.type == "cuda":
        # a kernel wrapper's first call inside the capture would build
        # and load the library
        kernels.library()
    t0 = time.perf_counter()
    with kernels.recording() as tally:
        graph = _capture(step, device)
    return graph, dict(tally), (time.perf_counter() - t0) * 1e3


def _count_replay(launches: Dict[str, int]) -> None:
    for name, k in launches.items():
        kernels.launches[name] += k


@contextlib.contextmanager
def _on(stream: Optional["torch.cuda.Stream"], device: torch.device):
    """Inside the block ``stream`` is current, queued behind the current
    stream's work; yields the stream that was current, which then waits
    for ``stream``'s work (None and nothing on the CPU)."""
    if stream is None:
        yield None
        return
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield current
    current.wait_stream(stream)


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

    def run(self, n: int) -> None:
        """``n`` steps, queued behind the current stream's work; the current
        stream waits for them."""
        if n <= 0:
            return
        with _on(self._stream, self.device):
            done = 0
            if self.graph is None:
                done = min(n, WARMUP_STEPS)
                for _ in range(done):
                    self.step()
                if done < n:
                    self._capture()
            for _ in range(n - done):
                self.graph.replay()
                _count_replay(self.launches)

    def _capture(self) -> None:
        self.graph, self.launches, self.capture_ms = _recorded_capture(
            self.step, self.device)
        self.pool_bytes = self.graph.pool_bytes


class _WhileCaptured:
    """Three parts captured on the card (``torch.cuda.CUDAGraph`` with
    ``keep_graph=True``, one memory pool, replayed in the order they were
    captured: pre, body as often as the flag decides, post) and the parent
    graph that ``csrc/graph_while.cu`` built of them.  The parts, their
    pool and the flag stay alive until the parent is destroyed."""

    def __init__(self, parts, flag: torch.Tensor, device: torch.device):
        lib = kernels.library()
        self.flag = flag
        self.counter = kernels.device_counter("graph_while", device)
        self.graphs: List = []
        self.tallies: List[Dict[str, int]] = []
        self._handle = None
        before = torch.cuda.memory_reserved(device)
        pool = torch.cuda.graph_pool_handle()
        collecting = gc.isenabled()
        gc.disable()  # as in :class:`_Captured`
        try:
            for part in parts:
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with kernels.recording() as tally:
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        part()
                    except BaseException:
                        with contextlib.suppress(Exception):
                            graph.capture_end()
                        raise
                    graph.capture_end()
                self.graphs.append(graph)
                self.tallies.append(dict(tally))
        finally:
            if collecting:
                gc.enable()
        if self.tallies[1]:
            raise RuntimeError(
                f"a while loop's body launches the port's kernels "
                f"{self.tallies[1]}: their count a launch would need a read "
                f"of the trials")
        self.pool_bytes = torch.cuda.memory_reserved(device) - before
        handle = ctypes.c_void_p()
        err = lib.ebt_while_build(
            *(ctypes.c_void_p(g.raw_cuda_graph()) for g in self.graphs),
            ctypes.c_void_p(flag.data_ptr()),
            ctypes.c_void_p(self.counter.data_ptr()), ctypes.byref(handle))
        if err != 0:
            raise RuntimeError(
                f"ebt_while_build failed with cudaError {err}: the CUDA "
                f"runtime refused the conditional WHILE graph")
        self._handle = handle
        self._lib = lib
        self.launches: Dict[str, int] = {}
        for tally in (self.tallies[0], self.tallies[2]):
            for name, k in tally.items():
                self.launches[name] = self.launches.get(name, 0) + k

    def replay(self) -> None:
        stream = torch.cuda.current_stream(self.flag.device).cuda_stream
        err = self._lib.ebt_while_launch(self._handle,
                                         ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"ebt_while_launch failed with cudaError "
                               f"{err}")

    def __del__(self):
        # the executable graph and the parent first, the parts after
        if self._handle is not None:
            self._lib.ebt_while_destroy(self._handle)
            self._handle = None
        self.graphs = []


def _while_capture(parts, flag: torch.Tensor, device: torch.device):
    """Capture ``parts = (pre, body, post)`` as one while graph; returns an
    object with ``replay()`` (one launch: ``pre``, ``body`` until ``flag``,
    at least once, ``post``), ``pool_bytes`` and ``launches`` (the port's
    kernel launches of ``pre`` and ``post``, a replay)."""
    return _WhileCaptured(parts, flag, device)


class WhileGraph:
    """Runs ``pre(); body() until flag; post()`` ``n`` times at a time on
    the graph route: the counterpart of a ``lax.while_loop`` inside a
    ``lax.scan``.

    ``flag`` is a one-byte (bool) tensor on the device that ``body``
    writes: nonzero stops the loop.  The three parts take no arguments
    and work on the loop's state in place, as :class:`StepGraph`'s step
    does.  The first :meth:`run` calls ``warmup()`` on the side stream (a
    pass over the parts that builds the libraries' lazy state and leaves
    the loop's state as it found it), captures the parts and builds the
    parent graph (``csrc/graph_while.cu``); every iteration after is one
    launch of it.  A capture or a build that fails raises: nothing falls
    back to reading the flag on the host.  The body's iterations are
    counted on the device (``kernels.device_launches("graph_while")``).
    """

    def __init__(self, pre: Callable[[], None], body: Callable[[], None],
                 post: Callable[[], None], flag: torch.Tensor,
                 device: torch.device,
                 warmup: Optional[Callable[[], None]] = None):
        self.parts = (pre, body, post)
        self.flag = flag
        self.device = device
        self.warmup = warmup
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.capture_ms: Optional[float] = None
        self.pool_bytes = 0
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def run(self, n: int) -> None:
        """``n`` iterations, queued behind the current stream's work; the
        current stream waits for them."""
        if n <= 0:
            return
        with _on(self._stream, self.device):
            if self.graph is None:
                if self.warmup is not None:
                    self.warmup()
                t0 = time.perf_counter()
                self.graph = _while_capture(self.parts, self.flag,
                                            self.device)
                self.capture_ms = (time.perf_counter() - t0) * 1e3
                self.launches = dict(self.graph.launches)
                self.pool_bytes = self.graph.pool_bytes
            for _ in range(n):
                self.graph.replay()
                _count_replay(self.launches)


# ---------------------------------------------------------------------------
# whole-function programs
# ---------------------------------------------------------------------------

def _leaves(tree) -> Iterator:
    """The leaves (tensors, numbers, None) of a nest of tuples, lists,
    dicts and named tuples, in order."""
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    else:
        yield tree


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(x, leaves) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return next(leaves)


def _map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to each tensor leaf."""
    return _rebuild(tree, (fn(x) if torch.is_tensor(x) else x
                           for x in _leaves(tree)))


def _signature(tree):
    """A hashable description of a nest: its structure and each tensor's
    shape, dtype and device (a number is described by its kind only)."""
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_signature(x) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _signature(v)) for k, v in tree.items()))
    if torch.is_tensor(tree):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if tree is None:
        return None
    if isinstance(tree, (bool, int, float)):
        return "number"
    raise TypeError(f"a program takes tensors, numbers and None, got "
                    f"{type(tree).__name__}")


def _clone(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in its own storage, with its strides: a view that
    skips memory (a pitched box, ``ops/cmax_cuda.py``, or an ROI crop) is
    copied with the span it covers, so the copy keeps the layout a kernel
    reads and an op's order of summation."""
    if t.is_contiguous() or t.numel() == 0 or \
            any(st <= 0 for st in t.stride()):
        return t.clone()  # a broadcast view is copied whole
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    covered = t.as_strided((span,), (1,), t.storage_offset()).clone()
    return covered.as_strided(t.shape, t.stride(), 0)


def _device_of(tree) -> torch.device:
    for x in _leaves(tree):
        if torch.is_tensor(x):
            return x.device
    raise ValueError("a program needs at least one tensor argument")


def _numbers_on(tree, device: torch.device):
    """``tree`` with each number as a 0-d float64 tensor on ``device``: a
    binary op with a floating tensor rounds it to the tensor's dtype, as a
    Python number is rounded."""
    return _rebuild(tree, (
        torch.full((), float(x), dtype=torch.float64, device=device)
        if isinstance(x, (bool, int, float)) else x for x in _leaves(tree)))


class _KeptCall:
    """One signature of a :class:`CapturedProgram`: the argument buffers,
    the captured call and its outputs."""

    def __init__(self, fn: Callable, args: Tuple, device: torch.device):
        self.fn = fn
        self.device = device
        self.buffers = _map(_clone, _numbers_on(args, device))
        self.outputs = None
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.capture_ms: Optional[float] = None
        self.pool_bytes = 0
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def _record(self) -> None:
        self.outputs = self.fn(*self.buffers)

    def first(self):
        """The first call: ``fn`` on the buffers eagerly (its result is the
        call's, and the run builds the libraries' lazy state), then the
        capture, on a side stream that the current stream waits for."""
        with _on(self._stream, self.device) as current:
            out = self.fn(*self.buffers)
            self.graph, self.launches, self.capture_ms = _recorded_capture(
                self._record, self.device)
        self.pool_bytes = self.graph.pool_bytes
        if current is not None:
            for t in _leaves(out):
                if torch.is_tensor(t):
                    # made on the side stream, used on the caller's
                    t.record_stream(current)
        return out

    def replay(self, args):
        """A later call: the arguments into the buffers, one replay on the
        current stream, copies of the outputs."""
        for dst, src in zip(_leaves(self.buffers), _leaves(args)):
            if torch.is_tensor(src):
                dst.copy_(src)
            elif src is not None:
                dst.fill_(float(src))
        self.graph.replay()
        _count_replay(self.launches)
        return _map(_clone, self.outputs)


class CapturedProgram:
    """``fn(*args)`` kept as a captured program per argument signature:
    the counterpart of a ``jax.jit`` program, which is compiled once per
    shape.

    ``fn`` takes tensors, numbers and None (in tuples, lists, dicts or
    named tuples such as ``Events``) and returns new tensors in such a
    nest.  On the graph route (:func:`graph_route`) the first call with a
    signature (the nest, each tensor's shape, dtype and device) copies its
    arguments into buffers of its own, runs ``fn`` on them eagerly (its
    result is the call's) and captures it; every later call with that
    signature copies its arguments into the buffers, replays and returns
    copies of the outputs, so a later call leaves an earlier result as it
    was.  Elsewhere (the CPU, :func:`eager_loops`) ``fn`` runs op by op on
    the arguments.  Either way a number reaches ``fn`` as a 0-d float64
    tensor (a buffer on the graph route), which a floating op rounds to its
    dtype as it would round the number.  The port's kernel launches of a
    replay are counted once per replay.  A capture that fails raises.
    """

    def __init__(self, fn: Callable):
        self.fn = fn
        self.kept: Dict[object, _KeptCall] = {}

    def __call__(self, *args):
        device = _device_of(args)
        if not graph_route(device):
            return self.fn(*_numbers_on(args, device))
        signature = _signature(args)
        call = self.kept.get(signature)
        if call is None:
            call = self.kept[signature] = _KeptCall(self.fn, args, device)
            return call.first()
        return call.replay(args)

    @property
    def capture_ms(self) -> List[float]:
        return [c.capture_ms for c in self.kept.values()]

    @property
    def pool_bytes(self) -> int:
        return sum(c.pool_bytes for c in self.kept.values())


# ---------------------------------------------------------------------------
# solve programs
# ---------------------------------------------------------------------------

class KeptSolve:
    """What a solve program keeps from frame to frame: the frame's
    constants in buffers of its own, the solve's loops over them (the
    loops of :mod:`event_based_bos_tpu_torch.optim`: a first-order,
    Nelder-Mead or Newton-CG loop, whose step is captured at its first run
    and replayed after, an L-BFGS loop, whose iteration is a
    :class:`WhileGraph`, or a sampler's program; each has a ``graph``
    attribute, None before its capture) and the interpolation matrices
    between scales.

    :meth:`bind` copies a frame's constants into the buffers; constants of
    another signature replace the buffers and drop the loops, and the
    caller builds new loops over :attr:`buffers`.
    """

    def __init__(self):
        self.buffers = None
        self.loops: List = []
        self._signature = None
        self._resize: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def bind(self, consts) -> bool:
        """Copy ``consts`` (a nest of tensors and None) into the buffers;
        returns True when the buffers were made anew (the first frame, or
        constants of another signature), whose loops the caller builds."""
        signature = _signature(consts)
        if signature == self._signature:
            for dst, src in zip(_leaves(self.buffers), _leaves(consts)):
                if src is not None:
                    dst.copy_(src)
            return False
        self.buffers = _map(_clone, consts)
        self._signature = signature
        self.loops = []
        return True

    def resize(self, image: torch.Tensor, out_shape) -> torch.Tensor:
        """``ops/image_warp.py::resize_bilinear`` with its two matrices
        built once per shape (a build copies from the host)."""
        from .ops.image_warp import resize_matrix

        h, w = image.shape[-2:]
        oh, ow = out_shape
        if (h, w) == (oh, ow):
            return image
        key = (h, w, oh, ow, image.dtype, image.device)
        if key not in self._resize:
            self._resize[key] = (
                resize_matrix(h, oh, image.dtype, image.device),
                resize_matrix(w, ow, image.dtype, image.device))
        mh, mw = self._resize[key]
        return torch.matmul(torch.matmul(mh, image), mw.T)

    def release(self) -> None:
        """Drop the loops' graphs and their memory pools now (a program used
        once): a loop and its graph refer to each other, so the collector
        would free them only at its next run."""
        for loop in self.loops:
            loop.release()

    @property
    def capture_ms(self) -> List[float]:
        return [loop.graph.capture_ms for loop in self.loops
                if loop.graph is not None and loop.graph.graph is not None]

    @property
    def pool_bytes(self) -> int:
        return sum(loop.graph.pool_bytes for loop in self.loops
                   if loop.graph is not None)
