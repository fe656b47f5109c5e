"""The port's tiled patch solvers (``solver/patch.py``) against the JAX
package's.

* The patch windows (``Tensor.unfold`` against JAX's vmapped
  ``dynamic_slice``, which clamps a last window that would run past the
  edge), the per-patch event counts and the active mask: exactly.
* The independent solve (every patch its own problem, in one batch) at
  64×96 with patch 8, stride 8 (and 4/2 with event-hist weights), and the
  joint solve with patch 16, in float64 on short schedules: the dense flow
  within 1e-6 (it agrees to ~1e-12).  The joint solve's random poisson
  init is passed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.solver.generative as jgen
import event_based_bos_tpu.solver.patch as jpatch
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.solver.generative as tgen
import event_based_bos_tpu_torch.solver.patch as tpatch
import event_based_bos_tpu_torch.types as ttypes
from torch_parity import (CPU, both_events, np_of, small_scene,
                          torch_threads)

H, W = 64, 96
ROI = (0, H, 16, 80)
NO_PXY = (("diff_norm", 1.0), ("image_gradient", 0.5))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _scene():
    events, frame, _gt = small_scene()
    fields = tuple(events[:, i].astype(np.float64) for i in range(4))
    jev, tev = both_events(fields)
    return jev, tev, frame.astype(np.float64)


def _specs(patch, stride, n_iter=30, thresholding=False, **g):
    kw = dict(image_size=(H, W), iwe_sigma=2.0,
              weight_by_inverse_event_hist=True, optimize_warp=True,
              poisson_model=False)
    kw.update(g)
    pkw = dict(roi=ROI, patch_size=patch, sliding_window=stride,
               n_iter=n_iter, do_event_thresholding=thresholding)
    return (jpatch.PatchSpec(gen=jgen.GenerativeSpec(dtype=jnp.float64, **kw),
                             **pkw),
            tpatch.PatchSpec(gen=tgen.GenerativeSpec(dtype=torch.float64,
                                                     **kw), **pkw))


@pytest.mark.parametrize("patch,stride", [(8, 8), (4, 2), (6, 4), (5, 3),
                                          (16, 16)])
def test_patch_windows_counts_and_mask_exactly(patch, stride):
    """(5, 3): 64 − 5 is no multiple of 3, so the last window is clamped."""
    jev, tev, _frame = _scene()
    grid = ttypes.PatchGrid((H, W), (patch, patch), (stride, stride))
    jgrid = jtypes.PatchGrid((H, W), (patch, patch), (stride, stride))
    image = np.random.default_rng(1).normal(size=(H, W))
    got = tpatch.extract_patches(torch.as_tensor(image), grid)
    want = jpatch.extract_patches(jnp.asarray(image), jgrid)
    assert got.shape == (grid.n_patch, patch, patch)
    assert np.array_equal(np_of(got), np_of(want))
    counts = tpatch.patch_event_counts(tev, grid)
    assert counts.dtype == torch.float32 and counts.shape == grid.shape
    assert np.array_equal(np_of(counts),
                          np_of(jpatch.patch_event_counts(jev, jgrid)))
    for thresholding in (False, True):
        jspec, tspec = _specs(patch, stride, thresholding=thresholding)
        mask = tpatch.active_patch_mask(tev, tspec)
        assert np.array_equal(np_of(mask),
                              np_of(jpatch.active_patch_mask(jev, jspec)))
    assert 0 < float(mask.sum()) < grid.n_patch


@pytest.mark.parametrize("patch,stride,model", [
    (8, 8, dict(angle_model=True)),
    (8, 8, dict(poisson_model=False)),
    (8, 8, dict(optimize_warp=False, cost_weights=NO_PXY)),
    (4, 2, dict(angle_model=True, weight_by_event_hist=True)),
], ids=["angle", "plain", "no_warp", "weights_4x2"])
def test_independent_solve_matches_jax(patch, stride, model):
    jev, tev, frame = _scene()
    jspec, tspec = _specs(patch, stride, thresholding=True, **model)
    jflow, jaux = jax.jit(lambda e, f: jpatch.estimate_frame_patch(
        e, f, jax.random.PRNGKey(0), jspec))(jev, jnp.asarray(frame))
    tflow, aux = tpatch.estimate_frame_patch(tev, frame, None, tspec,
                                             device=CPU)
    assert tflow.shape == (2, H, W) and tflow.dtype == torch.float64
    np.testing.assert_allclose(np_of(tflow), np_of(jflow), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_of(aux["losses"]), np_of(jaux["losses"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_of(aux["thetas"]), np_of(jaux["thetas"]),
                               rtol=0, atol=1e-6)
    assert np.abs(np_of(tflow)).max() > 0


def test_independent_patches_are_independent():
    """Each patch of the batched solve equals a solve of that patch
    alone."""
    _jev, tev, frame = _scene()
    _j, tspec = _specs(8, 8, n_iter=12, angle_model=True)
    ev, gx, gy, hist, weights, winv = tgen.frame_constants(tev, frame,
                                                           tspec.gen, CPU)
    active = tpatch.active_patch_mask(ev, tspec)
    _patched, aux = tpatch.solve_patches_independent(hist, weights, winv, gx,
                                                     gy, active, tspec)
    from event_based_bos_tpu_torch.optim import run_first_order

    grid = tspec.grid
    parts = [tpatch.extract_patches(a, grid)
             for a in (hist, gx, gy, winv)]
    norm = torch.sqrt(torch.sum(parts[0].reshape(grid.n_patch, -1) ** 2,
                                -1))
    m = parts[0] / torch.clamp(norm, min=1e-30)[:, None, None]
    for i in (0, 17, grid.n_patch - 1):
        res = run_first_order(
            lambda th: tpatch._patch_objective(th, m[i], parts[1][i],
                                               parts[2][i], parts[3][i],
                                               None, tspec),
            torch.tensor([np.pi, 0.0, 0.0], dtype=torch.float64), 12,
            lr=tspec.lr)
        np.testing.assert_allclose(np_of(aux["thetas"][i]), np_of(res.param),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("model", ["poisson", "angle", "plain"])
def test_joint_solve_matches_jax(monkeypatch, model):
    jev, tev, frame = _scene()
    jspec, tspec = _specs(16, 16, poisson_model=model == "poisson",
                          angle_model=model == "angle")
    shape = tspec.grid.shape
    init = np.zeros((tspec.gen.param_dim,) + shape)
    if model == "poisson":
        init[0] = np.random.default_rng(3).uniform(-1, 1, shape)
    elif model == "angle":
        init[0] = np.pi
    # the JAX joint solver draws its init through this name at call time
    monkeypatch.setattr(jgen, "initialize_params",
                        lambda key, shp, spec: jnp.asarray(init))
    jflow, jaux = jax.jit(lambda e, f: jpatch.estimate_frame_dependent(
        e, f, jax.random.PRNGKey(0), jspec))(jev, jnp.asarray(frame))
    tflow, aux = tpatch.estimate_frame_dependent(tev, frame, None, tspec,
                                                 init_params=init,
                                                 device=CPU)
    np.testing.assert_allclose(np_of(tflow), np_of(jflow), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_of(aux["history"]), np_of(jaux["history"]),
                               rtol=0, atol=1e-6)
    assert float(aux["history"][-1]) < float(aux["history"][0])


def test_joint_solve_draws_its_poisson_init_from_the_generator():
    _jev, tev, frame = _scene()
    _j, tspec = _specs(16, 16, n_iter=2, poisson_model=True)
    a = tpatch.estimate_frame_dependent(
        tev, frame, torch.Generator(CPU).manual_seed(1), tspec, device=CPU)
    b = tpatch.estimate_frame_dependent(
        tev, frame, torch.Generator(CPU).manual_seed(1), tspec, device=CPU)
    c = tpatch.estimate_frame_dependent(
        tev, frame, torch.Generator(CPU).manual_seed(2), tspec, device=CPU)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="Generator"):
        tpatch.estimate_frame_dependent(tev, frame, None, tspec, device=CPU)
