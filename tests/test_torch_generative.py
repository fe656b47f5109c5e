"""Parity of the port's generative-model blocks with the JAX package.

``iwe_cache`` is compared on integer sensor coordinates (the vote is then
bit-exact) in float32: the histogram blur and weight maps are the same
numpy operators, ≤ 1e-6 relative; the weight map's clip uses the
population std (ddof 0), which this comparison pins.  The dense objective
is compared in float32 (value and gradient ≤ 1e-5 relative) and float64
(≤ 1e-10).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.ops.iwe_pallas as ipk
import event_based_bos_tpu.solver.generative as jgen
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.ops.iwe as tiwe
import event_based_bos_tpu_torch.solver.generative as tgen
import event_based_bos_tpu_torch.types as ttypes
from torch_parity import CPU, both_events, np_of, rel_err, small_scene

H, W = 32, 48
TDT = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture(autouse=True)
def vote_interpret_mode():
    old = ipk.INTERPRET
    ipk.INTERPRET = True
    yield
    ipk.INTERPRET = old


def _specs(dtype="float32", **kw):
    base = dict(image_size=(H, W), iwe_sigma=2.0,
                weight_by_inverse_event_hist=True, optimize_warp=True,
                poisson_model=True)
    base.update(kw)
    return (jgen.GenerativeSpec(dtype=getattr(jnp, dtype), **base),
            tgen.GenerativeSpec(dtype=TDT[dtype], **base))


def _events():
    events, _frame, _gt = small_scene(H, W, n=1500)
    fields = tuple(events[:, i].astype(np.float32) for i in range(4))
    return both_events(fields, capacity=2048)


@pytest.mark.parametrize("kw", [
    {},
    {"no_polarity": True},
    {"weight_by_event_hist": True},
    {"weight_by_inverse_event_hist": False, "iwe_sigma": 0.0},
])
@pytest.mark.parametrize("pallas", [False, True])
def test_iwe_cache(kw, pallas):
    jspec, tspec = _specs(**kw)
    jev, tev = _events()
    want = jgen.iwe_cache(jev, dataclasses.replace(jspec, pallas_iwe=pallas))
    got = tgen.iwe_cache(tev, tspec)
    assert len(got) == 3
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert rel_err(a, b) <= 1e-6


@pytest.mark.parametrize("kw", [{}, {"weight_by_event_hist": True,
                                    "weight_sigma": 1.5}])
def test_iwe_cache_builds_its_blur_operators_once(kw, monkeypatch):
    """The blur operators are built once per shape, σ, mode, dtype and
    device, and the cache is bit-identical to blurring with operators
    built at every call."""
    _jspec, tspec = _specs(**kw)
    _jev, tev = _events()
    tgen._cached_blur_operators.cache_clear()
    got = tgen.iwe_cache(tev, tspec)
    built = tgen._cached_blur_operators.cache_info().misses
    assert built == 2 + bool(kw)  # iwe_sigma, 10 (and weight_sigma)
    again = tgen.iwe_cache(tev, tspec)
    assert tgen._cached_blur_operators.cache_info().misses == built
    monkeypatch.setattr(tgen, "_blur", lambda image, sigma, mode:
                        tiwe.gaussian_blur(image, sigma, mode=mode))
    want = tgen.iwe_cache(tev, tspec)
    for a, b, c in zip(got, again, want):
        assert (a is None) == (b is None) == (c is None)
        if a is not None:
            assert torch.equal(a, b) and torch.equal(a, c)


def test_measured_increment_with_and_without_weights_and_roi():
    rng = np.random.default_rng(0)
    hist = rng.normal(size=(H, W))
    wts = rng.uniform(0.1, 1.0, (H, W))
    for w in (None, wts):
        for roi in (None, (2, 20, 5, 40)):
            want = jgen.measured_increment(
                jnp.asarray(hist), None if w is None else jnp.asarray(w), roi)
            got = tgen.measured_increment(
                torch.as_tensor(hist), None if w is None else
                torch.as_tensor(w), roi)
            assert rel_err(got, want) <= 1e-12


@pytest.mark.parametrize("patch", [16, 8])
def test_patch_to_dense(patch):
    grid_j = jtypes.PatchGrid((H, W), (patch, patch), (patch, patch))
    grid_t = ttypes.PatchGrid((H, W), (patch, patch), (patch, patch))
    field = np.random.default_rng(1).normal(size=(3,) + grid_t.shape)
    want = jgen.patch_to_dense(jnp.asarray(field), grid_j)
    got = tgen.patch_to_dense(torch.as_tensor(field), grid_t)
    assert got.shape == (3, H, W)
    assert rel_err(got, want) <= 1e-12
    ops = tgen.dense_operators(grid_t, torch.float64, CPU)
    assert torch.equal(tgen.patch_to_dense(torch.as_tensor(field), grid_t,
                                           operators=ops), got)


@pytest.mark.parametrize("out_size,crop", [
    (None, (3, 29, 5, 41)), (None, (0, H, 0, W)), ((24, 40), None),
    ((24, 40), (2, 20, 0, 17)),
])
def test_patch_to_dense_crop_and_out_size(out_size, crop):
    """The cropped field (the CMax objective's ROI box) is the same two
    matmuls with the operators' rows and columns sliced."""
    grid_j = jtypes.PatchGrid((H, W), (8, 8), (8, 8))
    grid_t = ttypes.PatchGrid((H, W), (8, 8), (8, 8))
    field = np.random.default_rng(2).normal(size=(2,) + grid_t.shape)
    want = jgen.patch_to_dense(jnp.asarray(field), grid_j, out_size, crop)
    got = tgen.patch_to_dense(torch.as_tensor(field), grid_t, out_size, crop)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-12
    ops = tgen.dense_operators(grid_t, torch.float64, CPU, out_size, crop)
    assert torch.equal(tgen.patch_to_dense(torch.as_tensor(field), grid_t,
                                           operators=ops), got)


@pytest.mark.parametrize("kw", [{}, {"no_polarity": True},
                                {"warp_stencil_radius": 0}])
def test_predict_increment(kw):
    jspec, tspec = _specs("float64", **kw)
    rng = np.random.default_rng(2)
    flow = rng.normal(size=(2, H, W))
    gx, gy = rng.normal(size=(2, H, W))
    pxy = rng.uniform(-0.4, 0.4, (2, H, W))
    wts = rng.uniform(0.1, 1.0, (H, W))
    mask = (rng.uniform(size=(H, W)) > 0.3).astype(np.float64)
    want = jgen.predict_increment(*(jnp.asarray(a) for a in (flow, gx, gy)),
                                  jspec, jnp.asarray(pxy), jnp.asarray(wts),
                                  jnp.asarray(mask))
    got = tgen.predict_increment(*(torch.as_tensor(a) for a in (flow, gx, gy)),
                                 tspec, torch.as_tensor(pxy),
                                 torch.as_tensor(wts), torch.as_tensor(mask))
    assert rel_err(got, want) <= 1e-10


def test_predict_increment_zero_prediction_has_zero_subgradient():
    _, tspec = _specs("float64", optimize_warp=False, poisson_model=False)
    flow = torch.zeros((2, H, W), dtype=torch.float64, requires_grad=True)
    gxy = torch.ones((2, H, W), dtype=torch.float64)
    pred = tgen.predict_increment(flow, gxy[0], gxy[1], tspec)
    (g,) = torch.autograd.grad(pred.sum(), flow)
    assert torch.isfinite(g).all()


def _objective_inputs(dtype, patch=8, seed=3):
    rng = np.random.default_rng(seed)
    grid_t = ttypes.PatchGrid((H, W), (patch, patch), (patch, patch))
    grid_j = jtypes.PatchGrid((H, W), (patch, patch), (patch, patch))
    params = rng.uniform(-1, 1, (3,) + grid_t.shape)
    params[1:] *= 0.3
    arrays = dict(
        params=params,
        measured=rng.normal(size=(H, W)) / 40.0,
        gx=rng.normal(size=(H, W)) * 20, gy=rng.normal(size=(H, W)) * 20,
        weight_inverse=rng.uniform(0.05, 1.0, (H, W)),
        mask=np.pad(np.ones((H, W - 16)), ((0, 0), (8, 8))),
    )
    arrays = {k: v.astype(dtype) for k, v in arrays.items()}
    return arrays, grid_j, grid_t


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
@pytest.mark.parametrize("zero_pxy", [False, True])
def test_dense_objective_value_and_gradient(dtype, tol, zero_pxy):
    jspec, tspec = _specs(dtype)
    arrays, grid_j, grid_t = _objective_inputs(dtype)
    if zero_pxy:
        arrays["params"][1:] = 0.0
    rest = ("measured", "gx", "gy", "weight_inverse", "mask")

    def jf(p):
        return jgen.dense_objective(p, *(jnp.asarray(arrays[k]) for k in rest),
                                    grid_j, jspec)

    (jl, jterms), jg = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(arrays["params"]))
    p = torch.as_tensor(arrays["params"]).requires_grad_(True)
    tl, tterms = tgen.dense_objective(
        p, *(torch.as_tensor(arrays[k]) for k in rest), grid_t, tspec)
    (tg,) = torch.autograd.grad(tl, p)
    assert rel_err(tl, jl) <= tol
    assert np.isfinite(np_of(tg)).all()
    assert rel_err(tg, jg) <= tol
    for k in jterms:
        assert rel_err(tterms[k], jterms[k]) <= tol


def test_params_to_fields_keys():
    _, tspec = _specs("float64", cost_weights=(("diff_norm", 1.0),
                                               ("intensity_x", 1.0)))
    arrays, _g, grid_t = _objective_inputs("float64")
    fields = tgen.params_to_fields(torch.as_tensor(arrays["params"]), grid_t,
                                   tspec)
    assert set(fields) == {"flow", "pxy", "intensity"}
    assert fields["intensity"].shape == (H, W)
    assert fields["pxy"].shape == fields["flow"].shape == (2, H, W)


def test_initialize_params():
    _, tspec = _specs()
    g = torch.Generator(CPU).manual_seed(0)
    p = tgen.initialize_params(g, (4, 6), tspec, device=CPU)
    assert p.shape == (3, 4, 6) and p.dtype == torch.float32
    assert float(p[0].abs().max()) <= 1.0 and not p[1:].any()
    g2 = torch.Generator(CPU).manual_seed(0)
    assert torch.equal(p, tgen.initialize_params(g2, (4, 6), tspec, CPU))
    with pytest.raises(ValueError):
        tgen.initialize_params(None, (4, 6), tspec, device=CPU)
