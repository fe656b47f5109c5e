"""The whole slice: the port's ``estimate_frame`` against the JAX package's.

Both packages get the same small synthetic scene, the same IWE cache and
the same ``init_params`` (random streams differ between the frameworks).
In float64 — the facade's ``precision: 64`` path — the two solves must
agree to ≤ 1e-6 in the flow: every module agrees to rounding, and float64
keeps Adam's sign-like steps near zero gradients from amplifying it.  In
float32 the loss histories must agree to ≤ 1e-3 relative.  The flow must be
exactly +0.0 outside the ROI.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.solver.generative as jgen
import event_based_bos_tpu.solver.pyramid as jpyr
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.solver.generative as tgen
import event_based_bos_tpu_torch.solver.pyramid as tpyr
import event_based_bos_tpu_torch.types as ttypes
from event_based_bos_tpu_torch.convert import state_from_numpy
from torch_parity import CPU, np_of, rel_err, small_scene

H, W = 64, 96
ROI = (0, H, 16, 80)
TDT = {"float32": torch.float32, "float64": torch.float64}


def _specs(dtype, n_iter=24):
    kw = dict(image_size=(H, W), iwe_sigma=2.0,
              weight_by_inverse_event_hist=True, optimize_warp=True,
              poisson_model=True)
    pkw = dict(roi=ROI, coarsest_patch=16, finest_patch=8, n_iter=n_iter)
    jspec = jpyr.PyramidSpec(gen=jgen.GenerativeSpec(dtype=getattr(jnp, dtype),
                                                     **kw), **pkw)
    tspec = tpyr.PyramidSpec(gen=tgen.GenerativeSpec(dtype=TDT[dtype], **kw),
                             **pkw)
    return jspec, tspec


@functools.lru_cache(maxsize=None)
def _jax_inputs(dtype):
    """Scene, JAX events, the JAX-made cache and a numpy init (host arrays)."""
    jspec, tspec = _specs(dtype)
    events, frame, _gt = small_scene(H, W)
    jev = jtypes.events_from_ndarray(events, capacity=4096)
    cache = tuple(None if c is None else np.asarray(c)
                  for c in jgen.iwe_cache(jev, jspec.gen))
    gh, gw = tpyr.pyramid_grids(tspec)[0].shape
    rng = np.random.default_rng(7)
    init = np.zeros((3, gh, gw), dtype)
    init[0] = rng.uniform(-1, 1, (gh, gw))
    return events, frame.astype(dtype), jev, cache, init


def _jax_solve(dtype, init=None, prev=None):
    jspec, _ = _specs(dtype)
    _events, frame, jev, cache, init0 = _jax_inputs(dtype)
    fn = jax.jit(functools.partial(jpyr.estimate_frame, spec=jspec))
    mask = jnp.asarray(jpyr.roi_mask(jspec))
    return fn(jev, jnp.asarray(frame), mask, jax.random.PRNGKey(0),
              init_params=None if init is None else jnp.asarray(init),
              prev_params=None if prev is None else [jnp.asarray(p)
                                                     for p in prev],
              cache=tuple(None if c is None else jnp.asarray(c)
                          for c in cache))


def _torch_solve(dtype, init=None, prev=None, use_cache=True):
    _, tspec = _specs(dtype)
    events, frame, _jev, cache, _init0 = _jax_inputs(dtype)
    state = state_from_numpy({"cache": cache}, device=CPU)
    ev = ttypes.events_from_ndarray(events, capacity=4096, device=CPU)
    return tpyr.estimate_frame(
        ev, frame, tpyr.roi_mask(tspec), None, tspec, prev_params=prev,
        init_params=init, cache=state["cache"] if use_cache else None,
        device=CPU)


@pytest.fixture(scope="module")
def solves64():
    init = _jax_inputs("float64")[4]
    return _jax_solve("float64", init=init), _torch_solve("float64",
                                                          init=init)


def test_flow_float64_matches_jax(solves64):
    (jflow, jaux), (tflow, taux) = solves64
    assert tflow.shape == (2, H, W) and tflow.dtype == torch.float64
    np.testing.assert_allclose(np_of(tflow), np_of(jflow), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_of(taux["pxy"]), np_of(jaux["pxy"]),
                               rtol=0, atol=1e-6)
    for a, b in zip(taux["params_per_scale"], jaux["params_per_scale"]):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=0, atol=1e-6)
    for a, b in zip(taux["loss_history"], jaux["loss_history"]):
        assert rel_err(a, b) <= 1e-9
    for a, b in zip(taux["term_history"], jaux["term_history"]):
        assert set(a) == set(b)
        for k in a:
            assert rel_err(a[k], b[k]) <= 1e-9
    # the solve moved: the flow is not the init's, and pxy left zero
    assert float(np.abs(np_of(taux["pxy"])).max()) > 0


def test_flow_is_exact_positive_zero_outside_roi(solves64):
    _, (tflow, _) = solves64
    flow = np_of(tflow)
    outside = np.ones((H, W), bool)
    outside[ROI[0]:ROI[1], ROI[2]:ROI[3]] = False
    assert np.isfinite(flow).all()
    assert (flow[:, outside] == 0).all()
    assert not np.signbit(flow[:, outside]).any()
    assert np.abs(flow[:, ~outside]).max() > 0


def test_float32_loss_history_matches_jax():
    init = _jax_inputs("float32")[4]
    _jflow, jaux = _jax_solve("float32", init=init)
    tflow, taux = _torch_solve("float32", init=init)
    assert tflow.dtype == torch.float32
    for a, b in zip(taux["loss_history"], jaux["loss_history"]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-3)


def test_warm_start_matches_jax(solves64):
    (_jflow, jaux), _ = solves64
    prev = [np.asarray(p) for p in jaux["params_per_scale"]]
    jflow2, _ = _jax_solve("float64", prev=prev)
    tflow2, _ = _torch_solve("float64", prev=[torch.tensor(p)
                                              for p in prev])
    np.testing.assert_allclose(np_of(tflow2), np_of(jflow2), rtol=0,
                               atol=1e-6)


def test_events_path_equals_cache_path(solves64):
    """Without ``cache=``, the port builds the cache from the events (the
    vote's plain version on CPU) and lands on the same flow."""
    _, (tflow, _) = solves64
    init = _jax_inputs("float64")[4]
    tflow_ev, _ = _torch_solve("float64", init=init, use_cache=False)
    np.testing.assert_allclose(np_of(tflow_ev), np_of(tflow), rtol=0,
                               atol=1e-9)


def test_random_init_from_generator_is_seeded():
    _, tspec = _specs("float32", n_iter=6)
    events, frame, *_ = _jax_inputs("float32")
    ev = ttypes.events_from_ndarray(events, capacity=4096, device=CPU)
    mask = tpyr.roi_mask(tspec)
    runs = [tpyr.estimate_frame(ev, frame, mask,
                                torch.Generator(CPU).manual_seed(3), tspec,
                                device=CPU)[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError):
        tpyr.estimate_frame(ev, frame, mask, None, tspec, device=CPU)


def test_update_coarse_from_fine_matches_jax(solves64):
    (_jflow, jaux), _ = solves64
    jspec, tspec = _specs("float64")
    want = jpyr.update_coarse_from_fine(jaux["params_per_scale"], jspec)
    got = tpyr.update_coarse_from_fine(
        [torch.tensor(np.asarray(p)) for p in jaux["params_per_scale"]],
        tspec)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("size,roi,coarsest,finest,n_iter", [
    ((720, 1280), (0, 720, 320, 960), 64, 8, 600),
    ((64, 96), ROI, 16, 8, 24),
])
def test_schedule_grids_and_mask(size, roi, coarsest, finest, n_iter):
    jspec = jpyr.PyramidSpec(gen=jgen.GenerativeSpec(image_size=size),
                             roi=roi, coarsest_patch=coarsest,
                             finest_patch=finest, n_iter=n_iter)
    tspec = tpyr.PyramidSpec(gen=tgen.GenerativeSpec(image_size=size),
                             roi=roi, coarsest_patch=coarsest,
                             finest_patch=finest, n_iter=n_iter)
    assert tspec.n_scales == jspec.n_scales
    assert tpyr.scale_iterations(tspec) == jpyr.scale_iterations(jspec)
    assert [g.shape for g in tpyr.pyramid_grids(tspec)] == [
        g.shape for g in jpyr.pyramid_grids(jspec)]
    assert np.array_equal(tpyr.roi_mask(tspec), jpyr.roi_mask(jspec))
    assert tpyr.roi_mask(tspec).dtype == np.float32


def test_multistart_runs_and_returns_its_best_lane():
    """``n_restarts = 4`` from one generator: the flow of the lane with the
    lowest finest-scale loss, bit for bit (the lanes against the JAX
    package are in ``test_torch_pyramid_options.py``)."""
    _, tspec = _specs("float32", n_iter=8)
    spec = dataclasses.replace(tspec, n_restarts=4)
    _events, frame, _jev, cache, _init = _jax_inputs("float32")
    g = torch.Generator(CPU).manual_seed(3)
    flow, aux = tpyr.estimate_frame(None, frame, tpyr.roi_mask(spec), g,
                                    spec, cache=cache, device=CPU)
    g = torch.Generator(CPU).manual_seed(3)
    lanes = []
    for _ in range(4):
        x0 = tgen.initialize_params(g, tpyr.pyramid_grids(spec)[0].shape,
                                    spec.gen, CPU)
        lanes.append(tpyr.estimate_frame(None, frame, tpyr.roi_mask(spec),
                                         None, tspec, init_params=x0,
                                         cache=cache, device=CPU))
    scores = [float(a["loss_history"][-1].min()) for _f, a in lanes]
    best = int(np.argmin(scores))
    assert torch.equal(flow, lanes[best][0])
    assert float(aux["loss_history"][-1].min()) == min(scores)
    assert np.isfinite(np_of(flow)).all()
