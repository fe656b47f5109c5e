"""The port's ``parallel`` package on a 2×2 group of CPU ranks (gloo)
against its single-process solves and the JAX package's mesh steps.

One module-scoped group of four spawned ranks runs every case
(``torch_mesh_workers.parallel_cases``) and returns rank 0's results; it
must join within 120 s and finish within 300 s.  On integer event
coordinates every vote is an integer count, so the mesh steps equal the
single-process solves from the same inits bit for bit (flows and loss
histories).  Against JAX's steps (float64, on four of the eight virtual
CPU devices, ``solver.pyramid.initialize_params`` pinned to one init, as
the port's steps are given it) within 1e-6, on 48×64 frames whose
coarsest grid has three rows and at 12 iterations: the schedules and
grids at which the float64 parity of the pyramid holds.  The votes equal
JAX's sharded votes bit for bit on integer coordinates and within 1e-4 on
fractional ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.solver.pyramid as jpyramid
import torch_mesh_workers as workers
from event_based_bos_tpu import parallel as jparallel
from event_based_bos_tpu import solver as jsolver
from event_based_bos_tpu.types import events_from_ndarray as jevents
from event_based_bos_tpu_torch.ops.gradients import frame_gradients
from event_based_bos_tpu_torch.parallel import launch, make_mesh
from event_based_bos_tpu_torch.parallel.mesh import default_axis_shape
from event_based_bos_tpu_torch.solver.generative import iwe_cache
from event_based_bos_tpu_torch.solver.pyramid import (
    estimate_frame, roi_mask, select_restart, solve_pyramid,
    update_coarse_from_fine)
from event_based_bos_tpu_torch.types import events_from_ndarray

CPU = "cpu"


@pytest.fixture(scope="module")
def mesh_results():
    return launch.run(workers.parallel_cases, 4, device=CPU, timeout=120,
                      deadline=300)


def _port_events(arr):
    return events_from_ndarray(arr, capacity=len(arr), dtype=torch.float64,
                               device=CPU)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _jax_spec(n_iter=12, n_restarts=1):
    h, w = workers.SIZE
    gen = jsolver.GenerativeSpec(image_size=workers.SIZE, iwe_sigma=2.0,
                                 weight_by_inverse_event_hist=True,
                                 optimize_warp=True, poisson_model=True,
                                 dtype=jnp.float64)
    return jsolver.PyramidSpec(gen=gen, roi=(0, h, 8, w - 8),
                               coarsest_patch=16, finest_patch=8,
                               n_iter=n_iter, n_restarts=n_restarts)


@pytest.fixture
def jax_mesh(monkeypatch):
    """JAX's 2×2 mesh, its solves from ``workers.inits(1, 5)[0]``."""
    init = workers.inits(1, 5)[0]
    monkeypatch.setattr(jpyramid, "initialize_params",
                        lambda key, shape, spec: jnp.asarray(init,
                                                             spec.dtype))
    return jparallel.make_mesh((2, 2), devices=jax.devices()[:4])


def _jax_batch(arrays):
    return jparallel.stack_events([jevents(a, capacity=len(a),
                                           dtype=jnp.float64)
                                   for a in arrays])


def _keys(n):
    return jnp.stack([jax.random.PRNGKey(i) for i in range(n)])


def test_make_mesh_default_shapes_match_jax():
    for n in range(1, 9):
        want = jparallel.make_mesh(devices=jax.devices()[:n]).devices.shape
        assert default_axis_shape(n) == tuple(want), n
    mesh = make_mesh(devices=[CPU])
    assert mesh.axis_shape == (1, 1) and mesh.groups == {"data": None,
                                                         "event": None}
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2), devices=[CPU])


def test_mesh_of_the_rank_group(mesh_results):
    assert mesh_results["default_shape"] == (2, 2)
    assert mesh_results["backend"] == "gloo"


@pytest.mark.parametrize("fractional", [False, True])
def test_sharded_votes_match_jax(mesh_results, fractional):
    arrays = workers.event_arrays(4, 1, fractional=fractional)
    gen = _jax_spec().gen
    mesh = jparallel.make_mesh((2, 2), devices=jax.devices()[:4])
    want = np.asarray(jax.jit(lambda ev: jparallel.sharded_polarity_votes(
        ev, gen, mesh))(_jax_batch(arrays)))
    got = mesh_results[f"votes_frac{fractional}"]
    assert got.shape == want.shape == (4, 2) + workers.SIZE
    if fractional:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        assert _same(got, want)


def _single(arr, frame, x0, spec, prev=None):
    """The pyramid facade's solve of one frame in this process."""
    return estimate_frame(_port_events(arr), frame, roi_mask(spec), None,
                          spec, prev_params=prev,
                          init_params=None if prev is not None else x0,
                          device=CPU)


def test_estimator_equals_single_process(mesh_results):
    s = workers.spec()
    flows, hists = mesh_results["estimator"]
    for b, (arr, frame, x0) in enumerate(zip(
            workers.event_arrays(2, 2), workers.frames(2, 3),
            workers.inits(2, 4))):
        flow, aux = _single(arr, frame, x0, s)
        assert _same(flows[b], flow.numpy())
        for h, want in zip(hists, aux["loss_history"]):
            assert _same(h[b], want.numpy())


def test_estimator_matches_jax(mesh_results, jax_mesh):
    step = jparallel.make_multichip_estimator(_jax_spec(), jax_mesh)
    flows, _ = step(_jax_batch(workers.event_arrays(2, 2)),
                    jnp.asarray(workers.frames(2, 3)),
                    jnp.asarray(roi_mask(workers.spec())), _keys(2))
    got = mesh_results["estimator_shared"][0]
    assert np.abs(got - np.asarray(flows)).max() <= 1e-6


def test_multistart_equals_single_process(mesh_results):
    """The facade's multi-start on the same four inits: every lane solved
    on the shared IWE cache and gradients, the best picked on the
    device."""
    s4 = workers.spec(n_restarts=4)
    (arr,), (frame,) = workers.event_arrays(1, 6), workers.frames(1, 7)
    hist, weights, wi = iwe_cache(_port_events(arr), s4.gen)
    gx, gy = frame_gradients(torch.as_tensor(frame))
    mask = torch.as_tensor(roi_mask(s4))
    lanes = [solve_pyramid(hist, weights, wi, gx, gy, mask, None, s4,
                           init_params=torch.as_tensor(x0))
             for x0 in workers.inits(4, 8)]
    flow, aux = select_restart(lanes, s4.track_best)
    got_flow, got_hists = mesh_results["multistart"]
    assert got_flow.shape == (1, 2) + workers.SIZE
    assert _same(got_flow[0], flow.numpy())
    for h, want in zip(got_hists, aux["loss_history"]):
        assert _same(h[0], want.numpy())


def test_multistart_matches_jax_and_rejects_indivisible(mesh_results,
                                                        jax_mesh):
    s4 = _jax_spec(n_restarts=4)
    step = jparallel.make_multichip_multistart(s4, jax_mesh)
    flow, _ = step(_jax_batch(workers.event_arrays(1, 6)),
                   jnp.asarray(workers.frames(1, 7)),
                   jnp.asarray(roi_mask(workers.spec())), _keys(1))
    got = mesh_results["multistart_shared"][0]
    assert np.abs(got - np.asarray(flow)).max() <= 1e-6
    with pytest.raises(ValueError) as want:
        jparallel.make_multichip_multistart(
            dataclasses.replace(s4, n_restarts=3), jax_mesh)
    assert mesh_results["indivisible"] == str(want.value)


def _chains(x0s):
    """Two single-process warm-start chains of three frames, the steady
    schedule from the second."""
    s = workers.spec()
    steady = dataclasses.replace(s, n_iter=6)
    out = [[None] * 3 for _ in range(2)]
    for d in range(2):
        prev = None
        for t in range(3):
            arr = workers.event_arrays(2, 10 + t)[d]
            frame = workers.frames(2, 20 + t)[d]
            used = s if t == 0 else steady
            flow, aux = _single(arr, frame, x0s[d], used, prev)
            prev = update_coarse_from_fine(aux["params_per_scale"], used)
            out[d][t] = flow.numpy()
    return out


def test_sequential_equals_single_process_chains(mesh_results):
    want = _chains(workers.inits(2, 9))
    for t, flows in enumerate(mesh_results["sequential"]):
        for d in range(2):
            assert _same(flows[d], want[d][t]), (t, d)
    # carry_valid False kept lane 0's feedback; True replaced lane 1's
    assert list(mesh_results["carry"]) == [1.0, 1.0]


def test_sequential_matches_jax(mesh_results, jax_mesh):
    s = _jax_spec()
    cold, warm = jparallel.make_multichip_sequential(
        s, jax_mesh, steady_spec=dataclasses.replace(s, n_iter=6))
    mask = jnp.asarray(roi_mask(workers.spec()))
    prev = None
    for t in range(3):
        ev = _jax_batch(workers.event_arrays(2, 10 + t))
        fr = jnp.asarray(workers.frames(2, 20 + t))
        if t == 0:
            flows, prev, _ = cold(ev, fr, mask, _keys(2))
        else:
            flows, prev, _ = warm(ev, fr, mask, _keys(2), prev,
                                  jnp.array([True, True]))
        got = mesh_results["sequential_shared"][t]
        assert np.abs(got - np.asarray(flows)).max() <= 1e-6, t


def test_sweep_lanes_equal_single_solves(mesh_results):
    s = workers.spec(n_iter=8)
    (arr,), (frame,) = workers.event_arrays(1, 30), workers.frames(1, 31)
    hist, weights, wi = iwe_cache(_port_events(arr), s.gen)
    gx, gy = frame_gradients(torch.as_tensor(frame))
    mask = torch.as_tensor(roi_mask(s))
    flows, losses = mesh_results["sweep"]
    assert flows.shape == (4, 2) + workers.SIZE
    for i, (lr, x0) in enumerate(zip([0.01, 0.05, 0.1, 0.3],
                                     workers.inits(4, 32))):
        flow, aux = solve_pyramid(hist, weights, wi, gx, gy, mask, None, s,
                                  init_params=torch.as_tensor(x0),
                                  lr=float(np.float32(lr)))
        assert _same(flows[i], flow.numpy())
        assert losses[i] == float(aux["loss_history"][-1][-1])
    assert np.abs(flows[0] - flows[-1]).max() > 0


def test_dryrun_multichip_four_ranks(capsys):
    from event_based_bos_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(4, device=CPU)
    assert line.startswith("dryrun_multichip OK: mesh={'data': 2, "
                           "'event': 2}")
    assert "backend gloo" in line and line in capsys.readouterr().out


def test_failed_rank_is_raised_in_the_parent():
    """A rank's exception reaches the caller (the others are stopped)."""
    with pytest.raises(ValueError, match="needs 3 ranks"):
        launch.run(workers.bad_mesh, 2, device=CPU, timeout=60,
                   deadline=120)
