"""One run of one cell: the inputs from the seed, the facade as the CLI
builds it, the set-up, the measured window, the traced frames, the
comparison with the plain reference and the result line.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own that this module finds by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``scenes/<scene>.py``, ``reference/<reference>.py`` and
``metrics/<metric>.py``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import devtrace, scenes

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a measured process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "event_based_bos_tpu")

clock = time.perf_counter


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_spec(name: str, root: Path = ROOT):
    """``(bench, cell, config, traffic)`` of the cell ``name``."""
    bench = benchmark(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def metric_reader(name: str):
    return importlib.import_module(f"perfbench.metrics.{name}")


def reference_module(config: dict):
    return importlib.import_module(
        f"perfbench.reference.{config['reference']}")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - started


@dataclasses.dataclass
class Frame:
    """One solved frame: its solve index (every solve since the facade
    was built), its window, the host clock at its ``preprocess`` call,
    after its ``estimate_async`` returned and after its ``result()``
    returned, its flow, its per-scale loss histories and, where the
    solve gives them (:class:`FieldTap`), its per-scale best fields (on
    the device until the window has closed)."""

    index: int
    window: int
    submitted: float
    enqueued: float
    returned: float
    flow: np.ndarray
    losses: list
    fields: Optional[list] = None

    @property
    def latency_ms(self) -> float:
        return (self.returned - self.submitted) * 1e3

    @property
    def steps(self) -> int:
        return sum(int(h.shape[0]) for h in self.losses)


@dataclasses.dataclass
class Run:
    """What the readers of ``metrics/`` read."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    kind: str
    setup_s: float
    capture_s: float
    opened: float
    closed: float
    frames: List[Frame]
    epe: List[float]
    uploads: Dict[int, tuple]       # window → (capacity, events kept)
    trace: Optional[devtrace.Trace] = None
    traced: List[Frame] = dataclasses.field(default_factory=list)


def build_facade(config: dict, seed: int, device, overrides=None):
    """The facade of the configuration's method, built as the CLI builds
    it, with the run's seed."""
    from event_based_bos_tpu_torch.solver.facades import collections as reg

    solver = copy.deepcopy(config["solver"])
    solver.update(overrides or {})
    solver["seed"] = int(seed)
    crop = (solver["crop_height"], solver["crop_width"])
    return reg[solver["method"]](tuple(config["image_size"]), crop,
                                 calibration_parameter=None,
                                 solver_config=solver, visualize_module=None,
                                 device=device)


class FieldTap:
    """Keeps the best fields of every solve as the facade's solve function
    returns them, copies the program makes anyway: the pyramid's per-scale
    fields (``aux["params_per_scale"]``) and CMax's finest one
    (``aux["params"]``).  The reference evaluates its objective at them,
    works out the flow they give, and follows each of the pyramid's finer
    scales from the program's own start of it.  Installed once a process;
    costs a call and two assignments a frame."""

    count = 0
    last = None
    installed = False

    @classmethod
    def install(cls) -> None:
        if cls.installed:
            return
        from event_based_bos_tpu_torch.solver import facades

        def tap(original, key, wrap):
            def solve(*args, **kwargs):
                flow, aux = original(*args, **kwargs)
                cls.count += 1
                cls.last = wrap(aux[key]) if key in aux else None
                return flow, aux
            return solve

        facades.estimate_frame = tap(facades.estimate_frame,
                                     "params_per_scale", list)
        facades.estimate_frame_cmax = tap(facades.estimate_frame_cmax,
                                          "params", lambda p: [p])
        cls.installed = True


def _annotation(annotate: bool):
    return devtrace.phase if annotate else (
        lambda _name: contextlib.nullcontext())


def _submit(facade, windows, k: int, w: int, annotate: bool):
    win = windows[w]
    ann = _annotation(annotate)
    seen = FieldTap.count
    t0 = clock()
    with ann(devtrace.PHASES[0]):
        ev, _period = facade.preprocess(win.events, need_t=False)
    with ann(devtrace.PHASES[1]):
        handle = facade.estimate_async(ev, frame=win.frame)
    t1 = clock()
    fields = FieldTap.last if FieldTap.count > seen else None
    return k, w, t0, t1, handle, fields


def closed_loop(facade, windows, first: int, in_flight: int,
                until: Optional[float] = None, count: Optional[int] = None,
                annotate: bool = False, window: int = 0) -> List[Frame]:
    """Solve frames ``first, first + 1, …`` (solve indices; frame ``j`` of
    the loop takes window ``(window + j) mod len``) with ``in_flight``
    frames queued: frame ``k + in_flight − 1`` is queued before frame
    ``k``'s ``result()``.  Frames are submitted while the clock is before
    ``until``, or ``count`` frames in all; every frame submitted is waited
    for."""
    pending = collections.deque()
    done = []
    k = first

    def more():
        if count is not None:
            return k < first + count
        return clock() < until

    while True:
        while len(pending) < in_flight and more():
            pending.append(_submit(facade, windows, k,
                                   (window + k - first) % len(windows),
                                   annotate))
            k += 1
        if not pending:
            return done
        idx, w, t0, t1, handle, fields = pending.popleft()
        with _annotation(annotate)(devtrace.PHASES[2]):
            flow = handle.result()
        done.append(Frame(idx, w, t0, t1, clock(), flow,
                          list(handle.loss_history), fields))


def to_host(frames: List[Frame]) -> None:
    """Each frame's loss histories and fields, from the device."""
    for f in frames:
        f.losses = [h.detach().cpu().numpy() for h in f.losses]
        if f.fields is not None:
            f.fields = [p.detach().cpu().numpy() for p in f.fields]


def epe(flow: np.ndarray, true_flow: np.ndarray, sign: float,
        roi) -> float:
    """Mean endpoint error over the ROI of ``sign · flow`` against the
    true flow."""
    x0, x1, y0, y1 = roi
    d = (sign * np.asarray(flow, np.float64)[:, x0:x1, y0:y1]
         - true_flow[:, x0:x1, y0:y1])
    return float(np.mean(np.sqrt(d[0] ** 2 + d[1] ** 2)))


def roi_of(config: dict):
    p = config["solver"]["filter"]["parameters"]
    return p["xmin"], p["xmax"], p["ymin"], p["ymax"]


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def loss_gaps(frames: List[Frame], traj: Dict[int, np.ndarray],
              steps: int) -> np.ndarray:
    """``[steps]``: at each step the largest relative gap over ``frames``
    between the program's loss (the first scale's history, on the host)
    and the reference's, over the steps the reference compares (not NaN);
    inf where a history is short or not finite."""
    out = np.zeros(steps)
    for f in frames:
        got = np.asarray(f.losses[0][:steps], np.float64)
        want = traj[f.index]
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            return np.full(steps, math.inf)
        kept = np.isfinite(want)
        out[kept] = np.maximum(out[kept], np.abs(got - want)[kept]
                               / np.abs(want[kept]))
    return out


def compare(run: Run, windows, config: dict, device, log) -> Dict:
    """The numbers that decide ``correct``, each with its limit: the
    reference's loss trajectory against the program's, over the first
    steps of every frame of the window; the reference module's own
    numbers where it has them (the pyramid's finer scales, best fields
    and flow); where the configuration gives it a limit, the accuracy of
    every frame; each scale's schedule; the flows' assembly."""
    ref = reference_module(config)
    corr = config["correct"]
    steps = int(corr["steps"])
    limits = corr["limits"]
    solves = [(f.index, f.window) for f in run.frames]
    t0 = clock()
    traj = ref.trajectories(windows, solves, config, run.seed, steps, device)
    gap = float(np.max(loss_gaps(run.frames, traj, steps)))
    checks = {"loss_gap": (gap, limits["loss_gap"])}
    if hasattr(ref, "field_checks"):
        for name, value in ref.field_checks(run.frames, windows, config,
                                            run.seed, device).items():
            checks[name] = (value, limits[name])
    log(f"reference: {len(solves)} solves of {len({w for _s, w in solves})} "
        f"windows, {steps} steps each, {clock() - t0:.1f} s")
    if "epe_max" in limits:
        checks["epe_max"] = (max(run.epe) if run.epe else math.inf,
                             limits["epe_max"])
    checks["schedule_faults"] = (
        sum(ref.schedule_faults(f.losses, config) for f in run.frames), 0)
    checks["assembly_faults"] = (
        sum(ref.assembly_faults(f.flow, config) for f in run.frames), 0)
    return checks


def prepare(config: dict, traffic: dict, seed: int, dev, overrides=None,
            log=print):
    """A run's set-up after the imports: the windows from the seed, the
    facade, every window's upload once (its capacity, the kept programs'
    key, and the events the configured crop keeps), then ``prewarm`` of
    each capacity and one untimed frame on the first window of each (and,
    with frames in flight, one round of them).  Returns ``(windows,
    facade, uploads, solves so far, capture seconds)``."""
    import torch

    scene = scenes.load(traffic["scene"])
    windows = scene.make_windows(tuple(config["image_size"]),
                                 int(traffic["windows"]),
                                 int(traffic["events_per_window"]),
                                 traffic["scene_params"], seed)
    FieldTap.install()
    facade = build_facade(config, seed, dev, overrides)
    in_flight = int(traffic["in_flight"])
    uploads = {}
    for i, win in enumerate(windows):
        ev, _ = facade.preprocess(win.events, need_t=False)
        uploads[i] = (int(ev.capacity), int(ev.valid.sum()))
    t_cap = clock()
    first_of = {}
    for i, (cap, _n) in uploads.items():
        first_of.setdefault(cap, i)
    if hasattr(facade, "prewarm"):
        for cap in first_of:
            facade.prewarm(cap)
    k = 0   # solves since the facade was built
    for i in sorted(first_of.values()):
        closed_loop(facade, windows, k, 1, count=1, window=i)
        k += 1
    if in_flight > 1:
        closed_loop(facade, windows, k, in_flight, count=in_flight)
        k += in_flight
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    capture_s = clock() - t_cap
    log(f"set-up: {len(windows)} windows, uploads {uploads}, "
        f"{k} warm-up frames, capture {capture_s:.2f} s")
    return windows, facade, uploads, k, capture_s


def run_cell(cell: str, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device, metrics: List[dict],
             started: float, log=print) -> dict:
    """One run; returns the result line's object.  ``metrics`` are the
    entries of ``BENCHMARK.json`` that the run reports; ``started`` is the
    host clock of the process's start (``clock() − process_age_s()``)."""
    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    windows, facade, uploads, k, capture_s = prepare(
        config, traffic, seed, dev, None, log)
    in_flight = int(traffic["in_flight"])

    setup_s = clock() - started
    frames = closed_loop(facade, windows, k, in_flight,
                         until=clock() + seconds)
    k += len(frames)
    opened, closed = frames[0].submitted, frames[-1].returned
    log(f"window: {len(frames)} frames in {closed - opened:.3f} s")

    run = Run(cell, config, traffic, seed, "", setup_s, capture_s, opened,
              closed, frames, [], uploads)
    if trace:
        store = {}
        with devtrace.profiled(store):
            traced = closed_loop(facade, windows, k, in_flight,
                                 count=int(traffic["trace_frames"]),
                                 annotate=True)
        k += len(traced)
        run.traced = traced
        run.trace = devtrace.Trace(store["device"], store["host"],
                                   store["window"],
                                   sum(f.steps for f in traced))
        log(f"traced {len(traced)} frames after the window: "
            f"{len(store['device'])} device activities over "
            f"{run.trace.window_s:.3f} s")
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    run.kind = kind

    to_host(frames + run.traced)
    ref = reference_module(config)
    roi = roi_of(config)
    run.epe = [epe(f.flow, windows[f.window].true_flow, ref.FLOW_SIGN, roi)
               for f in frames]
    del facade
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks = compare(run, windows, config, dev, log)
    correct = all(v <= lim for v, lim in checks.values())
    values = {}
    for m in metrics:
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for f in frames if not np.all(np.isfinite(f.flow)))
    out_device = {"platform": "gpu" if on_card else dev.type, "kind": kind,
                  "count": 1, "memory_peak_bytes": peak}
    if on_card:
        out_device["power_limit"] = power_limit()
    if run.trace is not None:
        out_device["busy_s"] = run.trace.busy_s
        out_device["window_s"] = run.trace.window_s
    result = {"correct": bool(correct), "attempted": len(frames),
              "failed": failed, "metrics": values, "device": out_device}
    if run.trace is not None:
        result["breakdown"] = devtrace.breakdown(run.trace)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result
