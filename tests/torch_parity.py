"""Shared inputs for the parity tests of the PyTorch port (``test_torch_*``).

Every input is made with numpy from a fixed seed and handed to both the
JAX package and the port, so the two see identical numbers.
"""

import contextlib
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.types as ttypes
from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                      generate_sequence)

CPU = "cpu"


def np_of(a):
    """numpy view of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rand_event_fields(n, h, w, rng, fractional=False, spread=1.5):
    """``(x, y, t, p)`` float32 arrays; fractional coordinates also fall
    ``spread`` px outside the frame."""
    if fractional:
        x = rng.uniform(-spread, h - 1 + spread, n)
        y = rng.uniform(-spread, w - 1 + spread, n)
    else:
        x = rng.integers(0, h, n)
        y = rng.integers(0, w, n)
    p = rng.integers(0, 2, n) * 2 - 1
    t = np.sort(rng.uniform(0, 1, n))
    return tuple(a.astype(np.float32) for a in (x, y, t, p))


def both_events(fields, keep=None, capacity=None):
    """The same events as a JAX ``Events`` and a port ``Events`` (CPU)."""
    jev = jtypes.events_from_arrays(*fields, capacity=capacity)
    tev = ttypes.events_from_arrays(*fields, capacity=capacity, device=CPU)
    if keep is not None:
        jev = jev.mask_where(np.asarray(keep[:jev.capacity]))
        tev = tev.mask_where(torch.as_tensor(keep[:tev.capacity]))
    return jev, tev


@functools.lru_cache(maxsize=None)
def small_scene(h=64, w=96, n=2000, seed=0):
    """A small synthetic BOS window: ``(events (n, 4), frame, gt_flow)``."""
    cfg = SyntheticBosConfig(height=h, width=w, duration=1.0 / 30.0,
                             fps=30.0, events_per_frame=n,
                             max_displacement=3.0, plume_speed=300.0,
                             seed=seed)
    seq = generate_sequence(cfg)
    return seq["events"], seq["frames"][1], seq["gt_flow"][0]


def rel_err(a, b):
    a, b = np_of(a), np_of(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


SMALL_ROI = {"xmin": 0, "xmax": 64, "ymin": 16, "ymax": 80}


def small_config(name="synthetic_plume", output_dir=None, **top):
    """A shipped YAML config cut to a small scene (64×96, a few Adam steps
    per scale, float64, ``visualize: false``, frames 0–2 of
    ``time_list``), as a dict not yet propagated; ``top`` overrides
    top-level keys."""
    import pathlib

    import yaml

    path = pathlib.Path(__file__).resolve().parent.parent / "configs"
    with open(path / f"{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(height=64, width=96, duration=0.2, fps=30,
                       events_per_frame=3000)
    cfg["common_params"].update(SMALL_ROI)
    cfg["evaluation"]["time_list"] = [[0.01, 0.18]]
    solver = cfg["solver"]
    solver["precision"] = "64"
    if name == "synthetic_cmax":
        solver["optimizer"]["n_iter"] = 30
    else:
        solver["optimizer"]["n_iter"] = 12
        solver["patch_eklt"].update(coarsest_patch_size=16,
                                    finest_patch_size=8)
    cfg["visualize"] = False
    if output_dir is not None:
        cfg["output_dir"] = str(output_dir)
    cfg.update(top)
    return cfg


def pyramid_init(cfg, seed=7):
    """A numpy init of the coarsest pyramid scale for ``cfg`` (three
    parameter planes; the first drawn uniformly in [-1, 1))."""
    pe = cfg["solver"]["patch_eklt"]
    h, w = cfg["data"]["height"], cfg["data"]["width"]
    p = pe["coarsest_patch_size"]
    init = np.zeros((3, h // p, w // p))
    init[0] = np.random.default_rng(seed).uniform(-1, 1, init.shape[1:])
    return init


#: the estimator each facade calls and the keyword that pins its init
_INIT_HOOKS = {"pyramid": ("estimate_frame", "init_params"),
               "gml": ("estimate_frame_gml", "x0"),
               "dependent": ("estimate_frame_dependent", "init_params")}


def inject_init(monkeypatch, facades_module, init, solver="pyramid"):
    """Make ``facades_module``'s solves start from ``init`` on every cold
    frame: the estimator name of ``solver`` (``pyramid``: the coarsest
    scale; ``gml``: the parameter vector; ``dependent``: the joint field)
    is wrapped to pass the init (a warm-started frame keeps its
    previous-frame start).  The JAX package's joint facade binds its
    estimator when the class is made, so there the joint solver's
    ``initialize_params`` (looked up at call time) returns ``init``."""
    if solver == "dependent" and facades_module.__name__.startswith(
            "event_based_bos_tpu."):
        import jax.numpy as jnp

        import event_based_bos_tpu.solver.generative as jgen

        monkeypatch.setattr(
            jgen, "initialize_params",
            lambda key, shape, spec: jnp.asarray(init, spec.dtype))
        return
    name, keyword = _INIT_HOOKS[solver]
    orig = getattr(facades_module, name)

    def estimator(*args, **kwargs):
        if kwargs.get("prev_params") is None:
            kwargs[keyword] = init
        return orig(*args, **kwargs)

    monkeypatch.setattr(facades_module, name, estimator)


def jax_piv_multipass64(frame_a, frame_b, settings):
    """The JAX package's ``piv_multipass`` in float64 (that function casts
    the frames to float32): its passes (``piv._one_iteration``), ROI crop
    and output layout, on float64 frames."""
    import dataclasses

    import jax.numpy as jnp

    import event_based_bos_tpu.piv as jpiv

    fa = jnp.asarray(frame_a, jnp.float64)
    fb = jnp.asarray(frame_b, jnp.float64)
    x0, x1, y0, y1 = settings.roi or (0, fa.shape[0], 0, fa.shape[1])
    fa, fb = fa[x0:x1, y0:y1], fb[x0:x1, y0:y1]
    st = tuple(getattr(settings, f.name)
               for f in dataclasses.fields(settings))
    passes = [(w, o) for w, o in zip(settings.windowsizes, settings.overlap)
              if min(fa.shape) >= w]
    dense = None
    for k, (w, o) in enumerate(passes):
        dense = jpiv._one_iteration(fa, fb, int(w), int(o), st, dense,
                                    k == len(passes) - 1)
    out = np.zeros((2,) + np.shape(frame_a))
    out[:, x0:x1, y0:y1] = (np.asarray(dense) / settings.scaling_factor
                            / settings.dt)
    return out


def patch_window(seed, size, n=3000):
    """A seeded random window of ``size``: ``(events (n, 4) at integer
    pixels of the whole frame, a frame of uniform noise)``."""
    rng = np.random.default_rng(seed)
    h, w = size
    frame = rng.uniform(0, 255, (h, w))
    events = np.stack([rng.integers(0, h, n), rng.integers(0, w, n),
                       np.sort(rng.uniform(0.0, 0.03, n)),
                       rng.choice([-1.0, 1.0], n)], axis=1).astype(np.float64)
    return events, frame.astype(np.float32)


@contextlib.contextmanager
def torch_threads(n):
    """Run the block with ``n`` torch intra-op threads.  The solves of the
    facade and CLI tests are many small ops; under the suite's parallel
    workers, threads of each waiting on the others' cores cost far more
    than they save."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The graph route on the CPU: a stand-in capture and a host-read detector
# (``test_torch_graphs.py``, ``test_torch_programs.py``)
# ---------------------------------------------------------------------------

aten = torch.ops.aten


class NoHostReads(TorchDispatchMode):
    """Fails on an op that reads a tensor on the host or whose output shape
    depends on the data."""

    FORBIDDEN = {aten._local_scalar_dense, aten.nonzero, aten.masked_select,
                 aten.equal, aten.is_nonzero, aten.argwhere,
                 aten.repeat_interleave, aten.bincount, aten.masked_scatter}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        name = packet.__name__
        if packet in self.FORBIDDEN or name.startswith("unique") \
                or name.startswith("_unique"):
            raise AssertionError(f"{func} cannot be captured")
        if packet in (aten.index, aten.index_put, aten.index_put_):
            indices = args[1] if len(args) > 1 else kwargs.get("indices")
            if any(t is not None and t.dtype == torch.bool
                   for t in indices):
                raise AssertionError(f"{func} with a boolean mask cannot be "
                                     "captured")
        return func(*args, **kwargs)


class StubGraph:
    """A stand-in capture: records the step without running it; a replay
    runs it, the first one under :class:`NoHostReads`."""

    captured = []

    def __init__(self, step, device):
        self.step = step
        self.pool_bytes = 0
        self.replays = 0
        StubGraph.captured.append(self)

    def replay(self):
        if self.replays == 0:
            with NoHostReads():
                self.step()
        else:
            self.step()
        self.replays += 1


class StubWhile:
    """A stand-in while graph: a replay runs ``pre``, ``body`` until the
    flag is set (read here, as the card's WHILE node reads it on the
    device) and ``post``; the first replay runs each part under
    :class:`NoHostReads`.  Counts its body's runs in ``trials``."""

    captured = []

    def __init__(self, parts, flag, device):
        self.parts = parts
        self.flag = flag
        self.pool_bytes = 0
        self.launches = {}
        self.replays = 0
        self.trials = 0
        StubWhile.captured.append(self)

    def replay(self):
        pre, body, post = self.parts
        guard = NoHostReads if self.replays == 0 else contextlib.nullcontext
        with guard():
            pre()
        while True:
            with guard():
                body()
            self.trials += 1
            if bool(self.flag):
                break
        with guard():
            post()
        self.replays += 1


def clear_kept_programs():
    """Forget the port's kept per-frame evaluation programs (module-level
    caches, as the JAX package's ``jit_*`` factories are)."""
    from event_based_bos_tpu_torch.solver import programs

    for name in programs.__all__:
        if name.startswith("jit_"):
            getattr(programs, name).cache_clear()


def stub_capture(monkeypatch):
    """The graph route on the CPU (outside ``graphs.eager_loops()``),
    through :class:`StubGraph` and :class:`StubWhile`; returns the list of
    the step captures (the while captures are ``StubWhile.captured``)."""
    from event_based_bos_tpu_torch import graphs

    StubGraph.captured = []
    StubWhile.captured = []
    clear_kept_programs()
    monkeypatch.setattr(graphs, "graph_route",
                        lambda device: graphs._eager_depth == 0)
    monkeypatch.setattr(graphs, "_capture", StubGraph)
    monkeypatch.setattr(graphs, "_while_capture", StubWhile)
    return StubGraph.captured


def same_bits(a, b):
    """Whether two nests of tensors (dicts, lists, tuples) are equal bit for
    bit, the signs of zeros included."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y)
                                        for x, y in zip(a, b))
    if torch.is_tensor(a):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b) and torch.equal(a.signbit(),
                                                      b.signbit()))
    return a == b


# ---------------------------------------------------------------------------
# A CCS recording on disk (the helpers of ``test_pipeline_e2e.py``, with the
# port's copy of the synthetic generator and a choice of homography)
# ---------------------------------------------------------------------------

CCS_SIZE = (192, 256)
#: a homography that moves every pixel (shift, shear and a little
#: perspective), for the loader's ``warp: true``
CCS_HOMOGRAPHY = np.array([[1.02, 0.01, -1.5],
                           [0.005, 0.98, 2.0],
                           [1e-5, 0.0, 1.0]])


def encode_evt3(x, y, t_us, p):
    """A Prophesee EVT3 word stream of a time-sorted event list: TIME_HIGH
    (0x8) / TIME_LOW (0x6) as the µs clock moves, ADDR_Y (0x0) on a row
    change, one ADDR_X (0x2, bit 11 = polarity) per event."""
    words = [0x8 << 12, 0x6 << 12]
    high = low = 0
    cur_y = None
    for xi, yi, ti, pi in zip(x, y, t_us, p):
        th, tl = (int(ti) >> 12) & 0xFFF, int(ti) & 0xFFF
        assert int(ti) < (1 << 24), "the fixture keeps epoch 0"
        if th != high:
            words.append((0x8 << 12) | th)
            high = th
        if tl != low:
            words.append((0x6 << 12) | tl)
            low = tl
        if yi != cur_y:
            words.append((0x0 << 12) | int(yi))
            cur_y = yi
        words.append((0x2 << 12) | (int(pi) << 11) | int(xi))
    return np.asarray(words, np.uint16)


def write_ccs_recording(root, event_format, size=CCS_SIZE, seed=2,
                        events_per_frame=8000, homography=CCS_HOMOGRAPHY):
    """A synthetic recording in the CCS layout under ``root/CCS/synth``:
    events as ``events.hdf5`` or as a raw EVT3 capture
    (``cd_events.raw``), trigger edges, ``homography.txt`` and
    ``frames.mp4``.  Returns ``root``."""
    import pathlib

    import cv2

    h, w = size
    seq = generate_sequence(SyntheticBosConfig(
        height=h, width=w, duration=0.2, fps=30,
        events_per_frame=events_per_frame, seed=seed))
    root = pathlib.Path(root)
    d = root / "CCS" / "synth"
    (d / "prophesee_0").mkdir(parents=True)
    (d / "basler_0").mkdir(parents=True)
    ev = seq["events"]
    ev = ev[np.argsort(ev[:, 2], kind="stable")]
    xs = ev[:, 1].astype(np.int16)           # sensor x = col
    ys = ev[:, 0].astype(np.int16)           # sensor y = row
    ts = (ev[:, 2] * 1e6).astype(np.int32)
    ps = ev[:, 3] > 0
    if event_format == "hdf5":
        import h5py

        with h5py.File(d / "prophesee_0" / "events.hdf5", "w") as f:
            g = f.create_group("raw_events")
            for k, v in (("x", xs), ("y", ys), ("t", ts), ("p", ps)):
                g.create_dataset(k, data=v)
    else:
        (d / "prophesee_0" / "cd_events.raw").write_bytes(
            b"% evt 3.0 synthetic fixture\n% end\n"
            + encode_evt3(xs, ys, ts, ps).tobytes())
    ft = seq["frame_ts"]
    trig = np.stack([(ft * 1e6).astype(int), np.zeros(len(ft), int),
                     np.ones(len(ft), int)], 1)
    np.savetxt(d / "prophesee_0" / "trigger_events.txt", trig, fmt="%d")
    np.savetxt(d / "homography.txt", homography)
    vw = cv2.VideoWriter(str(d / "basler_0" / "frames.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    assert vw.isOpened(), "no mp4 codec"
    for fr in seq["frames"]:
        vw.write(cv2.cvtColor(fr.astype(np.uint8), cv2.COLOR_GRAY2BGR))
    vw.release()
    return root


def hot_plate_config(root, size=CCS_SIZE, n_iter=24, **top):
    """``configs/hot_plate1.yaml`` on a recording of
    :func:`write_ccs_recording`: its solver section as it stands but for
    ``n_iter`` and float64, the frame size, the ROI's columns scaled with
    the width, the time list inside the recording."""
    import pathlib

    import yaml

    path = pathlib.Path(__file__).resolve().parent.parent / "configs"
    with open(path / "hot_plate1.yaml") as f:
        cfg = yaml.safe_load(f)
    h, w = size
    cfg["data"].update(root=str(root), sequence="synth", height=h, width=w)
    cfg["common_params"].update(xmin=0, xmax=h, ymin=w // 4,
                                ymax=w - w // 4)
    cfg["evaluation"]["time_list"] = [[0.03, 0.15]]
    cfg["solver"]["optimizer"]["n_iter"] = n_iter
    cfg["solver"]["precision"] = "64"
    cfg.update(top)
    return cfg
