"""The CCS recording loader, the native host runtime and the host BAF/HOT
filters of the port against the JAX package's, and both CLIs on a CCS
recording.

A small synthetic recording (192×256, 0.2 s) is written to ``tmp_path`` in
the CCS layout, its events as HDF5 or as a raw EVT3 capture, with a
homography that moves every pixel.  The runtime's native and plain routes
are held bit for bit to the JAX package's native and numpy routes on the
inputs of ``tests/test_data_runtime.py``; the loaders' events, indices,
warped frames and batches bit for bit; the CLIs' error texts
(``configs/hot_plate1.yaml``'s solver section, float64, 24 iterations)
within 1e-6 relative and their flows within 1e-6 px.  192×256 is the
smallest size whose coarsest 64-px patch grid (3×4) keeps two float64
solves this close: on the 2-row grids of 128×192 and 128×128, Adam's
normalized first steps amplify rounding differences to 5.5e-7–2.4e-6 px.
"""

import ast
import logging
import pathlib

import numpy as np
import pytest
import torch
import yaml

import event_based_bos_tpu.cli as jcli
import event_based_bos_tpu.ops.filters as jfilters
import event_based_bos_tpu.runtime as jruntime
import event_based_bos_tpu.solver.facades as jfacades
import event_based_bos_tpu_torch.cli as tcli
import event_based_bos_tpu_torch.ops.filters as tfilters
import event_based_bos_tpu_torch.runtime as truntime
import event_based_bos_tpu_torch.solver.facades as tfacades
from event_based_bos_tpu.data import CcsDataLoader as JLoader
from event_based_bos_tpu_torch.data import collections as tcollections
from event_based_bos_tpu_torch.types import PatchGrid
from torch_parity import (CCS_SIZE, CPU, encode_evt3, hot_plate_config,
                          inject_init, np_of, torch_threads,
                          write_ccs_recording)

H, W = CCS_SIZE
TEXTS = ("flow_error_per_frame_without_mask.txt",
         "flow_error_per_frame_with_mask.txt")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def restore_logging():
    """``save_config`` replaces the root logger's handlers; put them
    back."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.fixture(params=["native", "plain"])
def route(request, monkeypatch):
    """Both packages' native routes, or the port's plain versions beside
    the JAX package's numpy fallbacks."""
    assert jruntime.ensure_built() and truntime.available()
    if request.param == "plain":
        monkeypatch.setattr(jruntime, "_load", lambda: None)
        monkeypatch.setattr(truntime, "_load", lambda: None)
    return request.param


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------

def test_searchsorted_and_window_match_jax(route):
    t = np.arange(0, 5000, 7, dtype=np.int32)
    for q in (0, 3, 7, 4998, 10_000):
        assert truntime.searchsorted(t, q) == jruntime.searchsorted(t, q)
    tf = t / 1e6
    for q in (0.0, 3e-6, 0.0049, 1.0):
        assert truntime.searchsorted(tf, q) == jruntime.searchsorted(tf, q)
    n = 50
    x = np.arange(n, dtype=np.int16)
    y = (x * 3).astype(np.int16)
    tt = x.astype(np.int32) * 1000 + 13
    p = (x % 2).astype(np.uint8)
    for i0, i1, cap in ((5, 25, 32), (0, 50, 40), (10, 12, 64)):
        got = truntime.window_padded(x, y, tt, p, i0, i1, cap)
        want = jruntime.window_padded(x, y, tt, p, i0, i1, cap)
        assert all(_same(a, b) for a, b in zip(got[:5], want[:5]))
        assert got[5] == want[5]


def test_baf_and_hot_match_jax(route):
    rng = np.random.default_rng(0)
    n = 400
    ev = np.stack([rng.integers(0, 24, n), rng.integers(0, 30, n),
                   np.sort(rng.uniform(0, 0.05, n)), rng.integers(0, 2, n)],
                  1).astype(np.float64)
    for ksize, support in ((1, 1), (2, 3)):
        tmaps = [None, None]
        for half in (ev[:200], ev[200:]):  # the map carried across calls
            kt, tmaps[0] = truntime.baf_filter(half, (24, 30), 0.004, ksize,
                                               support, time_map=tmaps[0])
            kj, tmaps[1] = jruntime.baf_filter(half, (24, 30), 0.004, ksize,
                                               support, time_map=tmaps[1])
            assert _same(kt, kj) and _same(*tmaps)
            assert 0 < kt.sum() < len(kt)
    hot = ev.copy()
    hot[:60, :2] = (3, 4)
    keep = truntime.hot_pixel_filter(hot, (24, 30), 10)
    assert _same(keep, jruntime.hot_pixel_filter(hot, (24, 30), 10))
    assert not keep[:60].any() and keep[60:].any()


def _fuzz_words():
    """The randomized EVT3 stream of ``test_data_runtime.py``: vector
    bursts, the TIME_HIGH wrap, ignored trigger and continuation words."""
    rng = np.random.default_rng(7)
    words = []
    high = 0xFFD
    for _ in range(6000):
        r = rng.random()
        if r < 0.04:
            words.append((0x8 << 12) | high)
            high = (high + 1) & 0xFFF
        elif r < 0.20:
            words.append((0x6 << 12) | int(rng.integers(0, 4096)))
        elif r < 0.35:
            words.append((0x0 << 12) | int(rng.integers(0, 720)))
        elif r < 0.55:
            words.append((0x2 << 12) | (int(rng.integers(0, 2)) << 11)
                         | int(rng.integers(0, 1280)))
        elif r < 0.75:
            words.append((0x3 << 12) | (int(rng.integers(0, 2)) << 11)
                         | int(rng.integers(0, 1200)))
            for _ in range(int(rng.integers(1, 4))):
                typ = 0x4 if rng.random() < 0.7 else 0x5
                nbits = 12 if typ == 0x4 else 8
                words.append((typ << 12) | int(rng.integers(1, 1 << nbits)))
        elif r < 0.85:
            words.append((0xA << 12) | int(rng.integers(0, 4096)))
        else:
            words.append((0x7 << 12) | int(rng.integers(0, 4096)))
    return np.asarray(words, np.uint16)


@pytest.mark.parametrize("port_route", ["native", "plain"])
@pytest.mark.parametrize("stream", ["hand", "fuzz"])
def test_decode_evt3_matches_jax(stream, port_route):
    """The JAX package decodes only natively: both port routes are held
    to its native decoder."""
    assert jruntime.ensure_built()
    if stream == "hand":
        words = np.asarray([(0x8 << 12) | 0x001, (0x6 << 12) | 0x123,
                            (0x0 << 12) | 55, (0x2 << 12) | (1 << 11) | 77,
                            (0x3 << 12) | 100, (0x4 << 12) | 0b101],
                           np.uint16)
        raw = b"% header line\n" + words.tobytes()
    else:
        raw = b"% hdr\n" + _fuzz_words().tobytes()
    decode = (truntime.decode_evt3 if port_route == "native"
              else truntime.decode_evt3_plain)
    got = decode(raw)
    want = jruntime.decode_evt3(raw)
    assert len(got["x"]) > (2 if stream == "hand" else 400)
    for k in ("x", "y", "t", "p"):
        assert _same(got[k], want[k]), k
    if stream == "fuzz":
        assert got["t"].max() >= 1 << 24  # across the TIME_HIGH wrap
    # the fixture's encoder round-trips
    x = np.array([5, 9, 9, 700], np.int16)
    y = np.array([1, 1, 3, 2], np.int16)
    t = np.array([10, 5000, 5000, 70000], np.int32)
    p = np.array([True, False, True, True])
    back = decode(b"%x\n" + encode_evt3(x, y, t, p).tobytes())
    assert all(_same(back[k], v) for k, v in zip("xytp", (x, y, t, p)))


def test_decode_evt3_routes_agree_after_an_odd_byte():
    """An odd byte between the header and the words is skipped by both
    routes (the JAX package's decoder rejects such a payload)."""
    raw = b"% hdr\n\x00" + _fuzz_words()[:500].tobytes()
    got, want = truntime.decode_evt3(raw), truntime.decode_evt3_plain(raw)
    assert len(got["x"]) > 400
    assert all(_same(got[k], want[k]) for k in "xytp")


# ---------------------------------------------------------------------------
# The loader and the host filters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    base = tmp_path_factory.mktemp("ccs")
    return {fmt: write_ccs_recording(base / fmt, fmt)
            for fmt in ("hdf5", "evt3")}


def _loaders(root, warp=True):
    cfg = {"root": str(root), "dataset": "CCS", "height": H, "width": W,
           "warp": warp}
    t, j = tcollections["CCS"](config=dict(cfg)), JLoader(dict(cfg))
    for loader in (t, j):
        loader.set_sequence("synth")
    return t, j


@pytest.mark.parametrize("fmt", ["hdf5", "evt3"])
def test_loader_matches_jax(recordings, fmt):
    t, j = _loaders(recordings[fmt])
    assert t.event_source == fmt
    assert len(t) == len(j) > 40_000
    assert all(_same(t.event_data[k], j.event_data[k]) for k in "xytp")
    assert _same(t.load_event(10, 5000), j.load_event(10, 5000))
    for q in (0.0, 0.01, 0.033, 0.0333334, 0.05, 0.15, 0.2):
        assert t.time_to_index(q) == j.time_to_index(q)
        assert t.time_to_image_index(q) == j.time_to_image_index(q)
    assert t.num_images == j.num_images == 7
    for i in (0, 3):
        (ti, tts), (ji, jts) = t.load_image(i), j.load_image(i)
        assert _same(ti, ji) and tts == jts and ti.shape == (H, W)
    unwarped, _ts = _loaders(recordings[fmt], warp=False)[0].load_image(3)
    assert not np.array_equal(unwarped, t.load_image(3)[0])
    batch = t.load_event_batch(100, 3100, 4096, dtype=torch.float64,
                               device=CPU)
    want = j.load_event_batch(100, 3100, 4096)
    assert batch.x.device.type == "cpu" and batch.capacity == 4096
    for a, b in zip(batch, want):
        assert np.array_equal(np_of(a), np.asarray(b).astype(
            np_of(a).dtype))
    assert int(batch.count()) == 3000
    with pytest.raises(IndexError):
        t.load_event(len(t), len(t) + 1)


def test_evt3_and_hdf5_recordings_hold_the_same_events(recordings):
    a, _ = _loaders(recordings["hdf5"])
    b, _ = _loaders(recordings["evt3"])
    assert all(np.array_equal(a.event_data[k], b.event_data[k])
               for k in "xyt")
    assert np.array_equal(a.event_data["p"].astype(bool),
                          b.event_data["p"].astype(bool))


def test_thermal_and_roi_info(tmp_path):
    seq = tmp_path / "CCS" / "t"
    (seq / "thermal").mkdir(parents=True)
    (seq / "prophesee_0").mkdir()
    arr = np.arange(12.0).reshape(3, 4)
    with open(seq / "thermal" / "frame0.csv", "w") as f:
        for row in arr:
            f.write(",".join(str(v) for v in row) + "\n")
    np.savetxt(seq / "prophesee_0" / "roi.csv", [[16, 0, 96, 64]],
               delimiter=",")
    t = tcollections["CCS"](config={"root": str(tmp_path), "height": 3,
                                    "width": 4})
    j = JLoader({"root": str(tmp_path), "dataset": "CCS", "height": 3,
                 "width": 4})
    t.dataset_files = t.get_sequence("t")
    j.dataset_files = j.get_sequence("t")
    assert t.num_thermals == 1
    assert _same(t.load_thermal(0), j.load_thermal(0))
    roi = str(seq / "prophesee_0" / "roi.csv")
    assert _same(t.load_recording_cropinfo(roi),
                 j.load_recording_cropinfo(roi))


def test_comma_separated_trigger_format(tmp_path):
    from event_based_bos_tpu.data.ccs import load_frame_timestamps as jload
    from event_based_bos_tpu_torch.data.ccs import load_frame_timestamps

    path = tmp_path / "trig.txt"
    np.savetxt(path, [[1, 0, 100], [0, 0, 150], [1, 0, 200]], fmt="%d",
               delimiter=",")
    assert _same(load_frame_timestamps(str(path)), jload(str(path)))


def test_host_baf_and_hot_over_two_windows_match_jax(recordings):
    t, _ = _loaders(recordings["hdf5"])
    cfg = {"filters": ["BAF", "HOT"],
           "parameters": {"xmin": 0, "xmax": H, "ymin": 16, "ymax": 112,
                          "BAF_dt": 0.002, "BAF_ksize": 1,
                          "BAF_num_support_event": 1,
                          "BAF_continuous_update": True, "HOT_thresh": 3}}
    tf = tfilters.EventFilter((H, W), cfg)
    jf = jfilters.EventFilter((H, W), cfg)
    for i0, i1 in ((0, 8000), (8000, 16000)):
        ev = t.load_event(i0, i1)
        got, want = tf.process_numpy(ev), jf.process_numpy(ev)
        assert _same(got, want) and 0 < len(got) < len(ev)
        assert _same(tf.np_time_map, jf.np_time_map)
    assert tf.np_time_map.max() > 0


# ---------------------------------------------------------------------------
# Both CLIs on the recording
# ---------------------------------------------------------------------------

def _run(tmp_path, tag, cfg, main, **kw):
    cfg = dict(cfg, output_dir=str(tmp_path / f"out_{tag}"))
    path = tmp_path / f"config_{tag}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    assert main(["--config_file", str(path), "--eval"], **kw) == 0
    return pathlib.Path(cfg["output_dir"])


def _lines(path):
    out = []
    for line in open(path):
        head, payload = line.split("::", 1)
        out.append((int(head.split()[1]), ast.literal_eval(payload)))
    return out


@pytest.mark.parametrize("filters", [None, ["BAF", "HOT"]],
                         ids=["crop", "baf_hot"])
def test_port_cli_matches_jax_cli_on_a_ccs_recording(tmp_path, monkeypatch,
                                                     recordings, filters):
    cfg = hot_plate_config(recordings["hdf5"], visualize=False)
    cfg["solver"]["filter"]["filters"] = filters
    shape = PatchGrid((H, W), (64, 64), (64, 64)).shape
    init = np.zeros((3,) + shape)
    init[0] = np.random.default_rng(7).uniform(-1, 1, shape)
    inject_init(monkeypatch, tfacades, init)
    inject_init(monkeypatch, jfacades, init)
    got = _run(tmp_path, "torch", cfg, tcli.main, device="cpu")
    want = _run(tmp_path, "jax", cfg, jcli.main)
    for name in TEXTS:
        g, w = _lines(got / name), _lines(want / name)
        assert [f for f, _ in g] == [f for f, _ in w] == [0, 1], name
        for (_, a), (_, b) in zip(g, w):
            assert list(a) == list(b)
            for k in b:
                assert abs(a[k] - b[k]) <= 1e-6 * abs(b[k]), (name, k, a, b)
            assert np.isfinite(a["EPE"])
    for i in range(2):
        a = np.load(got / f"pred_flow{i}.npy")
        b = np.load(want / f"pred_flow{i}.npy")
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert np.array_equal(np.signbit(a), np.signbit(b))


def test_port_cli_evt3_run_equals_hdf5_run(tmp_path, recordings):
    """The shipped config's loop as it stands (``visualize`` on) on both
    event sources: the flows bit for bit."""
    runs = {}
    for fmt in ("hdf5", "evt3"):
        cfg = hot_plate_config(recordings[fmt], n_iter=12)
        runs[fmt] = _run(tmp_path, fmt, cfg, tcli.main, device="cpu")
    flows = sorted(p.name for p in runs["evt3"].glob("pred_flow*.npy"))
    assert flows == [f"pred_flow{i}.npy" for i in range(2)]
    assert any(runs["evt3"].glob("pred_flow*.png"))
    for name in flows:
        a = np.load(runs["evt3"] / name)
        b = np.load(runs["hdf5"] / name)
        assert np.array_equal(a, b) and np.array_equal(np.signbit(a),
                                                       np.signbit(b))
        assert np.isfinite(a).all() and np.abs(a).max() > 0
    for name in TEXTS:
        assert (runs["evt3"] / name).read_text() == \
            (runs["hdf5"] / name).read_text()


def test_runtime_rejects_what_would_overrun_its_buffers():
    x = np.arange(10, dtype=np.int16)
    t = np.arange(10, dtype=np.int32)
    p = np.zeros(10, np.uint8)
    for i0, i1 in ((0, 11), (5, 3), (-1, 4)):
        with pytest.raises(ValueError):
            truntime.window_padded(x, x, t, p, i0, i1, 16)
    ev = np.zeros((20, 4))
    with pytest.raises(ValueError):
        truntime.baf_filter(ev, (8, 8), 0.01,
                            time_map=np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError):
        truntime.hot_pixel_filter(ev[:, :3], (8, 8), 3)
