"""Parity of the port's device event filters (``ops/filters.py``) with the
JAX package's and with the port's own host runtime.

Every input is made with numpy from a seed: a dense stream of integer
pixels (events clustered in bursts so that both keep and drop decisions
occur, and some events on the frame's border, where the BAF window is
truncated) with invalid padding slots.  Tolerances: bit for bit
everywhere — the exact BAF's keep mask and time map in float64 against
JAX (one event capacity throughout: each new shape costs JAX's filters a
compile), against the native runtime and its plain numpy version (over
windows that carry the time map), the fast BAF, HOT (also against the runtime's
host filter), the flicker split in float64, and the device pipeline of
``EventFilter.process`` against JAX's and against the host pipeline.  The
flicker's one deliberate divergence (float32 pixel keys) has its own test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.ops.filters as jfilters
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.ops.filters as tfilters
import event_based_bos_tpu_torch.types as ttypes
from event_based_bos_tpu_torch import kernels, runtime
from torch_parity import CPU, np_of, torch_threads

H, W = 64, 96
N = 20000
TDT = {"float32": torch.float32, "float64": torch.float64}
JDT = {"float32": jnp.float32, "float64": jnp.float64}


@pytest.fixture(autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


def dense_stream(n=N, h=H, w=W, seed=0, t0=0.0, span=0.05):
    """``(n, 4)`` float64 events on integer pixels, time-sorted: half
    uniform noise, half bursts of 40 events around random pixels within
    2 ms, a few on the frame's border."""
    rng = np.random.default_rng(seed)
    m = n // 2
    noise = np.stack([rng.integers(0, h, m), rng.integers(0, w, m),
                      rng.uniform(t0, t0 + span, m),
                      rng.integers(0, 2, m)], 1).astype(np.float64)
    nb = (n - m) // 40
    cx, cy = rng.integers(0, h, nb), rng.integers(0, w, nb)
    ct = rng.uniform(t0, t0 + span, nb)
    burst = np.stack([
        np.clip(np.repeat(cx, 40) + rng.integers(-1, 2, nb * 40), 0, h - 1),
        np.clip(np.repeat(cy, 40) + rng.integers(-1, 2, nb * 40), 0, w - 1),
        np.repeat(ct, 40) + rng.uniform(0, 0.002, nb * 40),
        rng.integers(0, 2, nb * 40)], 1).astype(np.float64)
    ev = np.concatenate([noise, burst])
    return ev[np.argsort(ev[:, 2], kind="stable")]


def both(arr, dtype="float64", capacity=N + 512):
    """The events as a JAX and a port batch of ``capacity`` slots (the
    rest invalid).  One capacity for every filter call: each new shape
    costs the JAX filters a compile."""
    jev = jtypes.events_from_ndarray(arr, capacity=capacity,
                                     dtype=JDT[dtype])
    tev = ttypes.events_from_ndarray(arr, capacity=capacity,
                                     dtype=TDT[dtype], device=CPU)
    return jev, tev


def _equal(a, b):
    return np.array_equal(np_of(a), np_of(b))


@pytest.mark.parametrize("ksize,support", [(1, 1), (1, 2)])
def test_exact_baf_matches_jax_and_the_runtime_over_carried_windows(
        ksize, support):
    """Three windows with the time map carried: keep masks and maps equal
    JAX's, the native runtime's and its plain numpy version's, bit for
    bit (float64)."""
    jmap = tmap = nmap = pmap = None
    kept = 0
    for i in range(3):
        arr = dense_stream(seed=i, t0=0.05 * i)
        jev, tev = both(arr)
        jout, jmap = jfilters.background_activity_filter(
            jev, (H, W), 0.005, ksize, support, time_map=jmap)
        tout, tmap = tfilters.background_activity_filter(
            tev, (H, W), 0.005, ksize, support, time_map=tmap)
        nkeep, nmap = runtime.baf_filter(arr, (H, W), 0.005, ksize, support,
                                         time_map=nmap)
        pkeep, pmap = runtime.baf_filter_plain(arr, (H, W), 0.005, ksize,
                                               support, time_map=pmap)
        assert tout.valid.dtype == torch.bool
        assert _equal(tout.valid, jout.valid)
        assert _equal(tmap, jmap) and tmap.dtype == torch.float64
        assert np.array_equal(np_of(tout.valid)[:len(arr)], nkeep)
        assert np.array_equal(np_of(tmap), nmap)
        assert np.array_equal(nkeep, pkeep) and np.array_equal(nmap, pmap)
        kept += int(nkeep.sum())
    assert 0 < kept < 3 * N


def test_exact_baf_of_an_empty_window_keeps_nothing():
    jev, tev = both(np.zeros((0, 4)))
    tout, tmap = tfilters.background_activity_filter(tev, (H, W), 0.005)
    jout, jmap = jfilters.background_activity_filter(jev, (H, W), 0.005)
    assert not tout.valid.any() and _equal(tmap, jmap)


@pytest.mark.parametrize("ksize,support,dt", [(1, 1, 0.005), (2, 2, 0.002)])
def test_fast_baf_matches_jax(ksize, support, dt):
    arr = dense_stream(seed=1)
    jev, tev = both(arr)
    jout = jfilters.background_activity_filter_fast(jev, (H, W), dt, ksize,
                                                     support)
    tout = tfilters.background_activity_filter_fast(tev, (H, W), dt, ksize,
                                                     support)
    assert _equal(tout.valid, jout.valid)
    assert 0 < int(tout.count()) < len(arr)


@pytest.mark.parametrize("thresh", [3, 10])
def test_hot_pixel_filter_matches_jax_and_the_runtime(thresh):
    arr = dense_stream(seed=2)
    arr[:300, :2] = (20, 30)  # one hot pixel
    jev, tev = both(arr)
    jout = jfilters.hot_pixel_filter(jev, (H, W), thresh)
    tout = tfilters.hot_pixel_filter(tev, (H, W), thresh)
    assert _equal(tout.valid, jout.valid)
    keep = runtime.hot_pixel_filter(arr, (H, W), thresh)
    assert np.array_equal(np_of(tout.valid)[:len(arr)], keep)
    assert 0 < int(tout.count()) < len(arr)


def flicker_stream(n=4000, seed=3, dtype=np.float64):
    """Events on a few pixels with alternating and repeated polarities and
    tied timestamps."""
    rng = np.random.default_rng(seed)
    ev = np.stack([rng.integers(0, 6, n), rng.integers(0, 8, n),
                   np.round(rng.uniform(0, 0.2, n), 3),
                   rng.integers(0, 2, n)], 1).astype(dtype)
    return ev


@pytest.mark.parametrize("dt", [0.001, 0.01])
def test_flicker_filter_matches_jax_in_float64(dt):
    arr = flicker_stream()
    jev, tev = both(arr, capacity=len(arr) + 100)
    jl, ju = jfilters.flicker_filter(jev, dt)
    tl, tu = tfilters.flicker_filter(tev, dt)
    assert _equal(tl.valid, jl.valid) and _equal(tu.valid, ju.valid)
    assert 0 < int(tl.count()) < len(arr)


def test_flicker_float32_pixel_key_collision_is_the_one_divergence():
    """JAX orders by the float key ``x·1e6 + y``; in float32 at row 719
    that key steps by 64, so columns 100 and 101 of that row collide and
    JAX links their polarity flip as flicker.  The port compares pixels
    exactly: no link.  In float64 both agree (no link)."""
    arr = np.array([[719, 100, 0.0, 0], [719, 101, 0.001, 1]] * 1
                   + [[5, 5, 0.5, 0]] * 10, np.float64)
    assert np.float32(719 * 1e6 + 100) == np.float32(719 * 1e6 + 101)
    for dtype, jax_links in (("float32", True), ("float64", False)):
        jev, tev = both(arr, dtype, capacity=len(arr))
        jl, _ = jfilters.flicker_filter(jev, 0.01)
        tl, _ = tfilters.flicker_filter(tev, 0.01)
        assert bool(np.asarray(jl.valid)[:2].all()) is jax_links
        assert not tl.valid[:2].any()


PIPELINE = {"xmin": 2, "xmax": 62, "ymin": 4, "ymax": 92, "BAF_dt": 0.005,
            "BAF_ksize": 1, "BAF_num_support_event": 1, "HOT_thresh": 10}


@pytest.mark.parametrize("filters,params", [
    (["BAF", "HOT"], {"BAF_continuous_update": True}),
    (["BAF"], {"BAF_fast": True}),
    (["HOT", "BAF"], {}),
])
def test_event_filter_process_matches_jax_and_the_host_pipeline(filters,
                                                                params):
    """The device pipeline over three windows: the same live events as
    JAX's ``process`` and (exact BAF) as the host pipeline through the
    native runtime, with the device time map carried where configured."""
    cfg = {"filters": filters, "parameters": dict(PIPELINE, **params)}
    tf = tfilters.EventFilter((H, W), cfg)
    jf = jfilters.EventFilter((H, W), cfg)
    hf = tfilters.EventFilter((H, W), cfg)
    assert tf.exact_baf == jf.exact_baf == (not params.get("BAF_fast"))
    for i in range(3):
        arr = dense_stream(seed=10 + i, t0=0.05 * i)
        arr[:200, :2] = (30, 40)
        jev, tev = both(arr)
        kernels.reset_launches()
        tout = tf.process(tev)
        assert kernels.launches["hat_vote_image"] == 0  # the CPU scatter
        jout = jf.process(jev)
        assert _equal(tout.valid, jout.valid)
        if tf.exact_baf:
            host = hf.process_numpy(arr)
            assert np.array_equal(tout.to_numpy(), host)
        if params.get("BAF_continuous_update"):
            assert _equal(tf.time_map, jf.time_map)
        else:
            assert tf.time_map is None
