"""Parity of the port's evaluation work with the JAX package's: the flow
metrics (``ops/flow.py::calculate_flow_error``), the per-frame programs of
``solver/programs.py`` (event mask, clipped IWE, FWL, the error pairs), the
event windows of ``ops/events.py`` and the CROP filter of
``ops/filters.py``.

Inputs are made with numpy from a seed and handed to both packages on the
CPU.  Tolerances: the metrics within 1e-12 relative in float64 and 1e-6 in
float32 (the reduction order differs from XLA's); the event mask and the
clipped IWE bit for bit; FWL within 1e-9 relative in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.ops.events as jevents
import event_based_bos_tpu.ops.filters as jfilters
import event_based_bos_tpu.ops.flow as jflow
import event_based_bos_tpu.ops.iwe as jiwe
import event_based_bos_tpu.solver.programs as jprog
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.ops.events as tevents
import event_based_bos_tpu_torch.ops.filters as tfilters
import event_based_bos_tpu_torch.ops.flow as tflow
import event_based_bos_tpu_torch.ops.iwe as tiwe
import event_based_bos_tpu_torch.solver.programs as tprog
import event_based_bos_tpu_torch.types as ttypes
from torch_parity import CPU, both_events, np_of, rand_event_fields

H, W = 40, 56
CROP = (4, 36, 8, 48)
TDT = {"float32": torch.float32, "float64": torch.float64}


def _flows(dtype, b=2, h=H, w=W, seed=0, nonfinite=False):
    """GT and prediction ``[b, 2, h, w]`` with zero GT pixels (invalid)
    among the valid ones, and NaN and inf ones with ``nonfinite``."""
    rng = np.random.default_rng(seed)
    gt = rng.normal(0, 3, (b, 2, h, w))
    pred = gt + rng.normal(0, 2, (b, 2, h, w))
    if nonfinite:
        gt[:, 0, :3, :5] = np.nan
        gt[:, 1, 5:8, :4] = np.inf
    gt[:, 0, 10:12, 10:30] = 0.0
    gt[:, 1, 20, :] = 0.0
    return gt.astype(dtype), pred.astype(dtype)


def _assert_errors_close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        g, w = float(got[k]), float(want[k])
        if np.isnan(w):
            assert np.isnan(g), (k, g, w)
            continue
        assert abs(g - w) <= rtol * max(abs(w), 1e-30), (k, g, w)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-6)])
@pytest.mark.parametrize("masked", [False, True])
def test_calculate_flow_error_matches_jax(dtype, rtol, masked):
    gt, pred = _flows(dtype)
    mask = None
    if masked:
        mask = np.random.default_rng(1).uniform(size=(2, 1, H, W)) > 0.4
    want = jflow.calculate_flow_error(
        jnp.asarray(gt), jnp.asarray(pred),
        event_mask=None if mask is None else jnp.asarray(mask))
    got = tflow.calculate_flow_error(
        torch.as_tensor(gt), torch.as_tensor(pred),
        event_mask=None if mask is None else torch.as_tensor(mask))
    assert all(v.dtype == TDT[dtype] for v in got.values())
    _assert_errors_close(got, want, rtol)
    assert float(got["1PE"]) > 0 and float(got["EPE"]) > 0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_calculate_flow_error_nonfinite_gt_matches_jax(dtype):
    """A NaN or inf GT pixel is left out of the count but, multiplied by
    the mask's 0, turns the sums into NaN, in both packages alike; the
    outlier ratios stay finite."""
    gt, pred = _flows(dtype, nonfinite=True)
    want = jflow.calculate_flow_error(jnp.asarray(gt), jnp.asarray(pred))
    got = tflow.calculate_flow_error(torch.as_tensor(gt),
                                     torch.as_tensor(pred))
    _assert_errors_close(got, want, 1e-12 if dtype == "float64" else 1e-6)
    assert np.isnan(float(got["EPE"])) and np.isfinite(float(got["1PE"]))


def test_calculate_flow_error_time_scale_matches_jax():
    gt, pred = _flows("float64")
    ts = np.array([0.5, 2.0])
    want = jflow.calculate_flow_error(jnp.asarray(gt), jnp.asarray(pred),
                                      time_scale=jnp.asarray(ts))
    got = tflow.calculate_flow_error(torch.as_tensor(gt),
                                     torch.as_tensor(pred),
                                     time_scale=torch.as_tensor(ts))
    _assert_errors_close(got, want, 1e-12)


def _events(fractional, dtype="float32", n=3000, seed=0):
    """The same masked events as a JAX and a port batch, in ``dtype``."""
    rng = np.random.default_rng(seed)
    fields = rand_event_fields(n, H, W, rng, fractional=fractional)
    keep = rng.uniform(size=n) > 0.2
    jev = jtypes.events_from_arrays(*fields, dtype=getattr(jnp, dtype))
    tev = ttypes.events_from_arrays(*fields, dtype=TDT[dtype], device=CPU)
    return (jev.mask_where(jnp.asarray(keep)),
            tev.mask_where(torch.as_tensor(keep)))


@pytest.mark.parametrize("fractional", [False, True])
def test_eventmask_and_clipped_iwe_bit_identical(fractional):
    jev, tev = _events(fractional, "float64")
    want = np.asarray(jprog.jit_eventmask((H, W))(jev))
    got = np_of(tprog.eventmask(tev, (H, W)))
    assert got.dtype == bool and got.shape == (1, H, W)
    assert np.array_equal(got, want)
    assert 0 < got.sum() < H * W
    want_c = np.asarray(jprog.jit_clipped_iwe((H, W))(
        jev, jnp.asarray(50.0, jnp.float32)))
    got_c = np_of(tprog.clipped_iwe(tev, (H, W), 50.0))
    assert got_c.dtype == np.uint8
    assert np.array_equal(got_c, want_c)


@pytest.mark.parametrize("method", ["count", "bilinear_vote", "polarity"])
def test_create_image_from_events_matches_jax(method):
    """The high-level images (here on the CPU, through the scatter) with a
    padding and the scipy-border blur, against the JAX package's."""
    jev, tev = _events(True, "float64")
    kw = dict(method=method, sigma=1.5, padding=(2, 3))
    want = np.asarray(jiwe.create_image_from_events(jev, (H, W), **kw))
    got = np_of(tiwe.create_image_from_events(tev, (H, W), **kw))
    lead = (2,) if method == "polarity" else ()
    assert got.shape == want.shape == lead + (H + 4, W + 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_of(tiwe.create_iwe(tev, (H, W))),
                               np.asarray(jiwe.create_iwe(jev, (H, W))),
                               rtol=0, atol=1e-12)
    assert np.array_equal(np_of(tiwe.create_eventmask(tev, (H, W), (2, 3))),
                          np.asarray(jiwe.create_eventmask(jev, (H, W),
                                                           (2, 3))))


@pytest.mark.parametrize("normalize_t", [False, True])
def test_fwl_matches_jax(normalize_t):
    jev, tev = _events(True, "float64")
    flow = np.random.default_rng(2).normal(0, 1.5, (2, H, W))
    want = float(jprog.jit_fwl((H, W), normalize_t)(jev, jnp.asarray(flow)))
    got = tprog.fwl(tev, torch.as_tensor(flow), (H, W), normalize_t)
    assert got.dtype == torch.float64
    assert abs(float(got) - want) <= 1e-9 * abs(want)


def test_flow_error_pair_matches_jax():
    jev, tev = _events(False, "float64")
    gt, pred = _flows("float32", b=1)
    x0, x1, y0, y1 = CROP
    gt_c, pred_c = gt[..., x0:x1, y0:y1], pred[..., x0:x1, y0:y1]
    want = jprog.jit_flow_error_pair((H, W), CROP)(
        jnp.asarray(gt_c), jnp.asarray(pred_c), jev)
    got = tprog.flow_error_pair(torch.as_tensor(gt_c),
                                torch.as_tensor(pred_c), tev, (H, W), CROP)
    for g, w in zip(got, want):
        _assert_errors_close(g, w, 1e-6)
    # the mask moves the numbers
    assert float(got[0]["EPE"]) != float(got[1]["EPE"])


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_flow_error_pair_device_matches_jax_and_host_pair(sign):
    """From the full-frame unoriented float64 flow, the device pair equals
    the JAX program's and, bit for bit, the host pair of the oriented
    float32 flow cropped to the ROI."""
    jev, tev = _events(False, "float64")
    gt, est = _flows("float64", b=1)
    gt, est = gt[0], est[0]
    x0, x1, y0, y1 = CROP
    gt_c = gt[:, x0:x1, y0:y1]
    want = jprog.jit_flow_error_pair_device((H, W), CROP)(
        jev, jnp.asarray(est), jnp.asarray(gt_c),
        jnp.asarray(sign, jnp.float32))
    got = tprog.flow_error_pair_device(tev, torch.as_tensor(est),
                                       torch.as_tensor(gt_c), sign, (H, W),
                                       CROP)
    for g, w in zip(got, want):
        assert all(v.dtype == torch.float32 for v in g.values())
        _assert_errors_close(g, w, 1e-6)
    oriented = (est.astype(np.float32) * np.float32(sign))[:, x0:x1, y0:y1]
    host = tprog.flow_error_pair(torch.as_tensor(gt_c.astype(np.float32))[None],
                                 torch.as_tensor(oriented)[None], tev, (H, W),
                                 CROP)
    for g, h in zip(got, host):
        assert all(torch.equal(g[k], h[k]) for k in g)


def test_crop_remove_and_time_period_match_jax():
    jev, tev = _events(True, "float64")
    for name in ("crop_event", "remove_event"):
        want = getattr(jevents, name)(jev, 5, 30, 10, 40)
        got = getattr(tevents, name)(tev, 5, 30, 10, 40)
        assert np.array_equal(np_of(got.valid), np.asarray(want.valid))
        assert 0 < int(got.count()) < int(tev.count())
    kept = tevents.crop_event(tev, 5, 30, 10, 40)
    removed = tevents.remove_event(tev, 5, 30, 10, 40)
    assert int(kept.count()) + int(removed.count()) == int(tev.count())
    want_t = float(jevents.time_period(jevents.crop_event(jev, 5, 30, 10,
                                                          40)))
    got_t = tevents.time_period(kept)
    assert float(got_t) == want_t and want_t > 0


FILTER_CONFIG = {"filters": None,
                 "parameters": {"xmin": 4, "xmax": 36, "ymin": 8, "ymax": 48,
                                "BAF_dt": 0.005, "HOT_thresh": 10}}


def test_event_filter_crop_matches_jax():
    rng = np.random.default_rng(3)
    arr = np.stack(rand_event_fields(2000, H, W, rng, fractional=True),
                   1).astype(np.float64)
    tf = tfilters.EventFilter((H, W), FILTER_CONFIG)
    jf = jfilters.EventFilter((H, W), FILTER_CONFIG)
    assert tf.filters == jf.filters == ["CROP"]
    got = tf.process_numpy(arr)
    assert np.array_equal(got, jf.process_numpy(arr))
    assert 0 < len(got) < len(arr)
    jev, tev = both_events(tuple(arr.T.astype(np.float32)))
    got_ev = tf.process(tev)
    assert np.array_equal(np_of(got_ev.valid),
                          np.asarray(jf.process(jev).valid))
    # the host and the batch pipelines keep the same events
    assert np.array_equal(got_ev.to_numpy(), got.astype(np.float32))
    # fewer than 10 events pass through unfiltered, as in the JAX package
    assert np.array_equal(tf.process_numpy(arr[:9]), arr[:9])


@pytest.mark.parametrize("name", ["BAF", "HOT"])
def test_baf_and_hot_filters_run_on_the_host_only(name):
    """BAF and HOT run in the host pipeline (before the upload), as the
    JAX package's; the device pipeline names the queue item that ports
    them."""
    cfg = dict(FILTER_CONFIG, filters=[name])
    tf = tfilters.EventFilter((H, W), cfg)
    jf = jfilters.EventFilter((H, W), cfg)
    assert tf.filters == jf.filters == ["CROP", name]
    rng = np.random.default_rng(4)
    n = 3000
    arr = np.stack([rng.integers(0, H, n), rng.integers(0, W, n),
                    np.sort(rng.uniform(0, 0.05, n)),
                    rng.integers(0, 2, n)], 1).astype(np.float64)
    arr[:400, :2] = (20, 30)  # one hot pixel
    got = tf.process_numpy(arr)
    assert np.array_equal(got, jf.process_numpy(arr))
    assert 0 < len(got) < len(tfilters.EventFilter(
        (H, W), FILTER_CONFIG).process_numpy(arr))
    _jev, tev = both_events(tuple(arr.T.astype(np.float32)))
    with pytest.raises(NotImplementedError, match="#14b"):
        tf.process(tev)


def test_unknown_filter_raises():
    with pytest.raises(KeyError):
        tfilters.EventFilter((H, W), dict(FILTER_CONFIG, filters=["XYZ"]))
