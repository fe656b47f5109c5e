"""Parity of the rest of the port's ops with the JAX package's: the event
helpers (``ops/events.py``), the weighted images and the event rate
(``ops/iwe.py``), the voxel grids (``ops/voxel.py``), the statistics
(``ops/stats.py``), the flow utilities (``ops/flow.py``), the resize and
padding helpers (``ops/image_warp.py``) and ``types.FlowPatch``.

Inputs are made with numpy from a seed and handed to both packages on the
CPU.  Tolerances, per test: bit for bit for the event helpers, the event
rate, the griddata propagation and ``estimate_corresponding_gt_flow``;
1e-12 relative in float64 for the weighted images, the statistics, the PDE
steps, the vote propagations and the flow voxels; the voxel grids, which
are float32 in both packages, 1e-6 relative.  ``generate_events`` draws
from a torch generator where JAX draws from a key: its properties are
compared, not its values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.ops.events as jevents
import event_based_bos_tpu.ops.flow as jflow
import event_based_bos_tpu.ops.image_warp as jwarp
import event_based_bos_tpu.ops.iwe as jiwe
import event_based_bos_tpu.ops.stats as jstats
import event_based_bos_tpu.ops.voxel as jvoxel
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch as tpkg
import event_based_bos_tpu_torch.ops.events as tevents
import event_based_bos_tpu_torch.ops.flow as tflow
import event_based_bos_tpu_torch.ops.image_warp as twarp
import event_based_bos_tpu_torch.ops.iwe as tiwe
import event_based_bos_tpu_torch.ops.stats as tstats
import event_based_bos_tpu_torch.ops.voxel as tvoxel
import event_based_bos_tpu_torch.types as ttypes
from torch_parity import CPU, np_of, rel_err, torch_threads

H, W = 24, 32
TDT = {"float32": torch.float32, "float64": torch.float64}
JDT = {"float32": jnp.float32, "float64": jnp.float64}


@pytest.fixture(autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


def events_pair(n=600, dtype="float64", seed=0, fractional=False,
                pm_polarity=False, invalid=60):
    """The same events as a JAX and a port batch (``invalid`` slots
    masked out, time-sorted, some time ties)."""
    rng = np.random.default_rng(seed)
    if fractional:
        x = rng.uniform(-1, H, n)
        y = rng.uniform(-1, W, n)
    else:
        x = rng.integers(0, H, n).astype(float)
        y = rng.integers(0, W, n).astype(float)
    t = np.sort(np.round(rng.uniform(0.1, 0.6, n), 3))
    p = rng.integers(0, 2, n).astype(float)
    if pm_polarity:
        p = p * 2 - 1
    keep = np.ones(n, bool)
    keep[rng.choice(n, invalid, replace=False)] = False
    fields = [a.astype(dtype) for a in (x, y, t, p)]
    jev = jtypes.events_from_arrays(*fields, dtype=JDT[dtype]).mask_where(
        jnp.asarray(keep))
    tev = ttypes.events_from_arrays(*fields, dtype=TDT[dtype],
                                    device=CPU).mask_where(
        torch.as_tensor(keep))
    return jev, tev


def same_events(jev, tev):
    return all(np.array_equal(np_of(a), np_of(b)) for a, b in zip(jev, tev))


# -- ops/events.py -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_event_helpers_match_jax(dtype):
    jev, tev = events_pair(dtype=dtype)
    cases = [
        (jevents.filter_event_by_time(jev, 0.2, 0.4),
         tevents.filter_event_by_time(tev, 0.2, 0.4)),
        (jevents.filter_event_by_time(jev, end_time=0.3),
         tevents.filter_event_by_time(tev, end_time=0.3)),
        (jevents.search_exact_event(jev, 3.0, 7.0),
         tevents.search_exact_event(tev, 3.0, 7.0)),
        (jevents.shift_event(jev, 1.5, -2.0),
         tevents.shift_event(tev, 1.5, -2.0)),
        (jevents.set_event_origin_to_zero(jev, 2, 3, 0.1),
         tevents.set_event_origin_to_zero(tev, 2, 3, 0.1)),
        (jevents.normalize_time(jev)[0], tevents.normalize_time(tev)[0]),
        (jevents.reverse_event(jev), tevents.reverse_event(tev)),
        (jevents.sort_event_by_timestamp(jevents.reverse_event(jev)),
         tevents.sort_event_by_timestamp(tevents.reverse_event(tev))),
        (jevents.split_polarity(jev)[0], tevents.split_polarity(tev)[0]),
        (jevents.split_polarity(jev)[1], tevents.split_polarity(tev)[1]),
    ]
    for i, (j, t) in enumerate(cases):
        assert same_events(j, t), i
    assert np.array_equal(np_of(jevents.normalize_time(jev)[1]),
                          np_of(tevents.normalize_time(tev)[1]))
    assert np.array_equal(np_of(jevents.time_period(jev)),
                          np_of(tevents.time_period(tev)))


def test_undistort_events_matches_jax():
    jev, tev = events_pair(dtype="float32")
    rng = np.random.default_rng(1)
    map_x = rng.integers(-2, W + 2, (H, W)).astype(np.int32)
    map_y = rng.integers(-2, H + 2, (H, W)).astype(np.int32)
    j = jevents.undistort_events(jev, jnp.asarray(map_x), jnp.asarray(map_y),
                                 H, W)
    t = tevents.undistort_events(tev, torch.as_tensor(map_x),
                                 torch.as_tensor(map_y), H, W)
    assert same_events(j, t)
    assert np.all(np_of(t.x) == np.round(np_of(t.x)))


def test_generate_and_sample_events_have_the_jax_properties():
    g = torch.Generator().manual_seed(0)
    ev = tevents.generate_events(g, 5000, H, W, 0.1, 0.4, device=CPU)
    jev = jevents.generate_events(jax.random.PRNGKey(0), 5000, H, W, 0.1, 0.4)
    for e in (ev, jev):
        x, y, t, p = (np_of(a) for a in e[:4])
        assert np.all(np.diff(t) >= 0) and t.min() >= 0.1 and t.max() < 0.4
        assert set(np.unique(x)) <= set(range(H)) and x.max() == H - 1
        assert set(np.unique(y)) <= set(range(W)) and y.max() == W - 1
        assert set(np.unique(p)) == {0.0, 1.0}
        assert np_of(e.valid).all() and e.x.dtype in (torch.float32,
                                                      jnp.float32)
    kept = tevents.random_sample_event(g, ev, 30.0)
    assert 0.25 < int(kept.count()) / 5000 < 0.35
    assert not (np_of(kept.valid) & ~np_of(ev.valid)).any()


# -- ops/iwe.py ----------------------------------------------------------------

@pytest.mark.parametrize("sigma", [0, 1])
def test_weighted_images_match_jax(sigma):
    jev, tev = events_pair(fractional=True)
    rng = np.random.default_rng(2)
    wts = rng.uniform(0.5, 1.5, jev.capacity)
    jw, tw = jnp.asarray(wts), torch.as_tensor(wts)
    pairs = [
        (jiwe.create_probability_iwe(jev, (H, W), jw, sigma),
         tiwe.create_probability_iwe(tev, (H, W), tw, sigma)),
        (jiwe.create_timeimage(jev, (H, W), sigma=sigma),
         tiwe.create_timeimage(tev, (H, W), sigma=sigma)),
        (jiwe.create_timeimage(jev, (H, W), jw, sigma, (2, 3)),
         tiwe.create_timeimage(tev, (H, W), tw, sigma, (2, 3))),
        (jiwe.create_iwa(jev, (H, W), jw, sigma),
         tiwe.create_iwa(tev, (H, W), tw, sigma)),
        (jiwe.create_iwd(jev, (H, W), jw, sigma),
         tiwe.create_iwd(tev, (H, W), tw, sigma)),
        (jiwe.create_iwt(jev, (H, W), jw, sigma, (1, 1)),
         tiwe.create_iwt(tev, (H, W), tw, sigma, (1, 1))),
    ]
    for i, (j, t) in enumerate(pairs):
        assert t.shape == j.shape and t.dtype == torch.float64, i
        assert rel_err(t, j) <= 1e-12, (i, rel_err(t, j))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_event_rate_matches_jax(dtype):
    jev, tev = events_pair(n=2000, dtype=dtype)
    j = jiwe.create_eventrate(jev, (H, W))
    t = tiwe.create_eventrate(tev, (H, W))
    assert np.array_equal(np_of(t), np_of(j)) and (np_of(t) > 0).any()


# -- ops/voxel.py ----------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
def test_event_voxel_matches_jax(normalize):
    jev, tev = events_pair(fractional=True, pm_polarity=True)
    j = jvoxel.create_event_voxel(jev, (5, H, W), normalize)
    t = tvoxel.create_event_voxel(tev, (5, H, W), normalize)
    assert t.dtype == torch.float32 and t.shape == j.shape
    assert rel_err(t, j) <= 1e-6


def test_discretized_volume_matches_jax():
    jev, tev = events_pair(fractional=True, pm_polarity=True)
    j = jvoxel.generate_discretized_event_volume(jev, (10, H, W))
    t = tvoxel.generate_discretized_event_volume(tev, (10, H, W))
    assert t.dtype == torch.float32 and rel_err(t, j) <= 1e-6


# -- ops/stats.py ------------------------------------------------------------------

def test_stats_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 9))
    assert rel_err(tstats.gaussian_1d(0.3, 1.7, torch.as_tensor(x)),
                   jstats.gaussian_1d(0.3, 1.7, jnp.asarray(x))) <= 1e-12
    assert rel_err(tstats.charbonnier_loss(torch.as_tensor(x)),
                   jstats.charbonnier_loss(jnp.asarray(x))) <= 1e-12
    a = rng.uniform(0, 1, (2, 3, 20, 24))
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    for size_average in (True, False):
        t = tstats.ssim(torch.as_tensor(a), torch.as_tensor(b),
                        size_average=size_average)
        j = jstats.ssim(jnp.asarray(a), jnp.asarray(b),
                        size_average=size_average)
        assert rel_err(t, j) <= 1e-12
    assert rel_err(tstats.ssim(torch.as_tensor(a[0, 0]),
                               torch.as_tensor(a[0, 0])), 1.0) <= 1e-12


# -- ops/flow.py -----------------------------------------------------------------

def _flow(seed=4, b=None, scale=2.0):
    rng = np.random.default_rng(seed)
    shape = (2, H, W) if b is None else (b, 2, H, W)
    return rng.normal(0, scale, shape)


def test_flow_generators_and_reductions_match_jax():
    u = tflow.generate_uniform_optical_flow((H, W), 1.5, -2.0, device=CPU)
    assert np.array_equal(np_of(u), np_of(
        jflow.generate_uniform_optical_flow((H, W), 1.5, -2.0)))
    g = torch.Generator().manual_seed(1)
    d = tflow.generate_dense_optical_flow(g, (H, W), 5.0, device=CPU)
    assert d.shape == (2, H, W) and d.dtype == torch.float32
    assert -5.0 <= float(d.min()) and float(d.max()) < 5.0
    vox = _flow(b=6)
    vox[2] = 0.0
    assert rel_err(tflow.truncate_voxel_flow(torch.as_tensor(vox)),
                   jflow.truncate_voxel_flow(jnp.asarray(vox))) <= 1e-12
    ts = np.array([0.5, 2.0])
    f = _flow(b=2)
    assert rel_err(tflow.convert_flow_per_bin_to_flow_per_sec(
        torch.as_tensor(f), torch.as_tensor(ts), 4),
        jflow.convert_flow_per_bin_to_flow_per_sec(
            jnp.asarray(f), jnp.asarray(ts), 4)) <= 1e-12


@pytest.mark.parametrize("dt", [0.3, -0.3])
def test_pde_steps_and_propagation_match_jax(dt):
    f = _flow()
    tf, jf = torch.as_tensor(f), jnp.asarray(f)
    for tfn, jfn in ((tflow.upwind_step, jflow.upwind_step),
                     (tflow.burgers_step, jflow.burgers_step),
                     (tflow.propagate_flow_bilinear,
                      jflow.propagate_flow_bilinear),
                     (tflow.propagate_flow_max, jflow.propagate_flow_max)):
        assert rel_err(tfn(tf, dt), jfn(jf, dt)) <= 1e-12, tfn.__name__
    fb = _flow(b=2)
    assert rel_err(tflow.upwind_step(torch.as_tensor(fb), dt),
                   jflow.upwind_step(jnp.asarray(fb), dt)) <= 1e-12


@pytest.mark.parametrize("scheme,t0", [
    ("upwind", "middle"), ("burgers", "first"), ("bilinear", "middle"),
    ("max", "first"), ("same", "middle"), ("zero", "middle"),
    ("nearest", "middle")])
def test_flow_voxel_matches_jax(scheme, t0):
    f = _flow(b=2, scale=1.0)
    t = tflow.construct_dense_flow_voxel(torch.as_tensor(f), 5, scheme, t0,
                                         clamp=2.5)
    j = jflow.construct_dense_flow_voxel(jnp.asarray(f), 5, scheme, t0,
                                         clamp=2.5)
    assert t.shape == j.shape == (2, 5, 2, H, W)
    assert rel_err(t, j) <= 1e-12 if scheme != "zero" else not t.any()


@pytest.mark.parametrize("method", ["nearest", "linear"])
def test_griddata_propagation_matches_jax(method):
    f = _flow(scale=1.0)
    t = tflow.propagate_flow_griddata(f, 0.5, method)
    j = jflow.propagate_flow_griddata(f, 0.5, method)
    assert np.array_equal(t, j, equal_nan=True)


@pytest.mark.parametrize("window", [(0.02, 0.04), (0.01, 0.075)])
def test_estimate_corresponding_gt_flow_matches_jax(window):
    rng = np.random.default_rng(5)
    xs = rng.normal(0, 2, (5, 1, H, W))
    ys = rng.normal(0, 2, (5, 1, H, W))
    xs[:, :, :3] = 0.0
    ts = np.array([0.0, 0.02, 0.04, 0.06, 0.08])
    t = tflow.estimate_corresponding_gt_flow(xs, ys, ts, *window)
    j = jflow.estimate_corresponding_gt_flow(xs, ys, ts, *window)
    assert all(np.array_equal(a, b) for a, b in zip(t, j))


# -- ops/image_warp.py, types.FlowPatch --------------------------------------------

@pytest.mark.parametrize("stride", [(2, 3), (4, 4), (1, 2)])
def test_phased_upsample_matches_jax_and_the_resize(stride):
    rng = np.random.default_rng(6)
    f = rng.normal(size=(2, 5, 7))
    t = twarp.upsample_bilinear_phased(torch.as_tensor(f), stride)
    j = jwarp.upsample_bilinear_phased(jnp.asarray(f), stride)
    assert rel_err(t, j) <= 1e-12
    out = (5 * stride[0], 7 * stride[1])
    assert rel_err(t, twarp.resize_bilinear(torch.as_tensor(f), out)) <= 1e-12


def test_padding_helpers_match_jax():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(2, 5, 7))
    cfg = {"pad_x0": 1, "pad_x1": 2, "pad_y0": 3, "pad_y1": 0}
    assert np.array_equal(
        np_of(twarp.pad_to_same_resolution(torch.as_tensor(a), cfg, -1.0)),
        np_of(jwarp.pad_to_same_resolution(jnp.asarray(a), cfg, -1.0)))
    for shape in ((10, 12), (2, 9, 8)):
        assert np.array_equal(
            np_of(twarp.pad_to_same_resolution_center(torch.as_tensor(a),
                                                      shape, 2.0)),
            np_of(jwarp.pad_to_same_resolution_center(jnp.asarray(a),
                                                      shape, 2.0)))


def test_flow_patch_matches_jax():
    import event_based_bos_tpu as jpkg

    jp = jpkg.FlowPatch(x=10.0, y=20.0, shape=(8, 6), u=1.0, v=-2.0)
    tp = tpkg.FlowPatch(x=10.0, y=20.0, shape=(8, 6), u=1.0, v=-2.0)
    tp.update(3, 4)
    jp.update(3, 4)
    for name in ("x_min", "x_max", "y_min", "y_max"):
        assert getattr(tp, name) == getattr(jp, name)
    assert np.array_equal(tp.position, jp.position)
    assert np.array_equal(tp.flow, jp.flow) and tp.u == 3.0
    assert ttypes.FlowPatch is tpkg.FlowPatch
