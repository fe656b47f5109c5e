"""The traced frames: ``torch.profiler`` (CUPTI) around whole frames, read
into plain records.

The harness profiles a few frames after the window has closed, marks them
with host annotations of its own, and hands the per-layer readers a
:class:`Trace`: every device activity (kernels, copies, memsets) with its
name and its interval, the host annotations, and the span of the traced
frames, all on the profiler's clock in seconds.  A traced run that records
no device activity fails: its per-layer numbers would be empty.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

from . import timeline

#: host annotations the harness puts around the traced frames
WINDOW = "perfbench.traced_frames"
PHASES = ("perfbench.preprocess", "perfbench.enqueue", "perfbench.result")


@dataclasses.dataclass
class Activity:
    name: str
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass
class Trace:
    device: List[Activity]
    host: List[Activity]
    window: Tuple[float, float]
    steps: int            # optimizer steps in the traced frames

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        """Seconds in the traced span in which a device activity ran."""
        return timeline.union_length(((a.start, a.end) for a in self.device),
                                     *self.window)

    def kernels(self, name: str = "") -> List[Activity]:
        """Kernel activities of the function ``name`` (a demangled name,
        template arguments included, without return type or namespace),
        or every kernel."""
        return [a for a in self.device if a.is_kernel
                and (not name or _function(a.name) == name)]


def _function(name: str) -> str:
    """A demangled kernel name's function: ``void (anonymous
    namespace)::f<2, true>(float*, int)`` → ``f<2, true>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, cut, last = 0, len(name), 0
    for i, ch in enumerate(name):
        if ch in "<(":
            if ch == "(" and depth == 0:
                cut = i
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif ch == ":" and depth == 0 and name.startswith("::", i):
            last = i + 2
    return name[last:cut].strip()


@contextlib.contextmanager
def profiled(store: Dict):
    """Profile the block (host and device activity) and put its
    :class:`Trace` pieces into ``store`` on exit: ``device``, ``host`` and
    ``window`` (the :data:`WINDOW` annotation's span)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
        torch.cuda.synchronize()
    device, host = [], []
    window = None
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start") * 1e-9
        end = start + _ns(ev, "duration") * 1e-9
        act = Activity(ev.name(), start, end)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # the device-side copies of host annotations are no activity
            if not (_annotation(ev) or act.name.startswith("perfbench.")):
                device.append(act)
        else:
            host.append(act)
            if act.name == WINDOW:
                window = (act.start, act.end)
    if not device:
        raise RuntimeError("the profiler recorded no device activity in the "
                           "traced frames")
    if window is None:
        raise RuntimeError("the traced frames' annotation is missing from "
                           "the trace")
    store.update(device=device, host=host, window=window)


def _annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def _ns(ev, what: str) -> int:
    """A kineto event's start or duration in ns (older builds give µs)."""
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def phase(name: str):
    """A host annotation for one phase of a traced frame."""
    from torch.profiler import record_function

    return record_function(name)


def breakdown(trace: Trace, top: int = 10) -> Dict:
    """The device operations that took most time (summed by name) and the
    device's idle time in the traced span by what the host was doing then
    (the innermost host activity over each gap's middle, summed by
    name)."""
    by_op: Dict[str, float] = {}
    for a in trace.device:
        by_op[a.name] = by_op.get(a.name, 0.0) + a.seconds
    idle: Dict[str, float] = {}
    host = sorted(trace.host, key=lambda a: a.start)
    for s, e in timeline.gaps(((a.start, a.end) for a in trace.device),
                              *trace.window):
        mid = (s + e) / 2
        covering = [a for a in host if a.start <= mid <= a.end
                    and a.name != WINDOW]
        name = (min(covering, key=lambda a: a.seconds).name if covering
                else "host: nothing traced")
        idle[name] = idle.get(name, 0.0) + (e - s)

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(idle)}
