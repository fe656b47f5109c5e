"""Parity of the port's CMax solver (``solver/cmax.py``) with JAX.

Each route of the binned dense objective is held against its own JAX
counterpart, because the two routes differ at the hat's kinks:

* ``use_kernel=False`` (the stencil sum under autograd) against JAX's
  off-TPU route (the jnp stencil sum), in float64: the IWE and its flow
  gradient within 1e-10, a whole dense solve within 1e-6 px;
* ``use_kernel=True`` (on the CPU: the CUDA kernels' plain versions)
  against JAX's Pallas route, with the kernel in interpret mode and the
  solver told that its backend is a TPU (a proxy of the ``jax`` module in
  ``solver.cmax``; no file of the JAX package changes), in float32: the
  IWE within 1e-5 and its gradient within 1e-6 abs, a short dense solve
  (50 Adam steps) within 5e-4 px: float32 rounding, amplified by Adam.

At flow 0 every tap of the stencil sits on a kink: the kernel route's
contrast gradient is exactly 0 there, the stencil route's is not — in the
port and in JAX alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.ops.cmax_pallas as cp
import event_based_bos_tpu.solver.cmax as jcmax
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.solver.cmax as tcmax
import event_based_bos_tpu_torch.types as ttypes
from torch_parity import CPU, np_of, rel_err

H, W = 48, 64
TDT = {"float32": torch.float32, "float64": torch.float64}


class _TpuBackendJax:
    """The ``jax`` module, except that ``default_backend()`` says TPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setattr(cp, "INTERPRET", True)
    monkeypatch.setattr(jcmax, "jax", _TpuBackendJax())


def moving_edge_events(vx, vy, n=6000, seed=0):
    """The scene of ``tests/test_cmax.py``: a rigidly translating dot
    pattern."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, n))
    x0 = rng.choice(np.arange(6, H - 14, 4), n).astype(float)
    y0 = rng.choice(np.arange(6, W - 14, 5), n).astype(float)
    x = x0 + vx * t + rng.normal(0, 0.1, n)
    y = y0 + vy * t + rng.normal(0, 0.1, n)
    p = np.ones(n)
    return np.stack([x, y, t, p], 1)


def _both_events(evn, dtype):
    jev = jtypes.events_from_ndarray(evn, dtype=getattr(jnp, dtype))
    tev = ttypes.events_from_ndarray(evn, dtype=TDT[dtype], device=CPU)
    return jev, tev


def _specs(dtype, use_kernel, **kw):
    jspec = jcmax.CmaxSpec(dtype=getattr(jnp, dtype), use_pallas=use_kernel,
                           **kw)
    tspec = tcmax.CmaxSpec(dtype=TDT[dtype], use_kernel=use_kernel, **kw)
    return jspec, tspec


@pytest.mark.parametrize("direction", ["middle", "first", 0.3])
def test_binned_histograms_bit_equal_on_integer_coordinates(direction):
    evn = moving_edge_events(2.0, -3.0, n=4000, seed=1)
    evn[:, :2] = np.round(evn[:, :2])
    jspec, tspec = _specs("float32", True, image_size=(H, W), time_bins=16,
                          direction=direction)
    jev, tev = _both_events(evn, "float32")
    jh, jd = jcmax.binned_histograms(jev, jspec)
    th, td = tcmax.binned_histograms(tev, tspec)
    assert th.shape == (16, H, W) and th.dtype == torch.float32
    assert np.array_equal(np_of(th), np_of(jh))
    assert np.array_equal(np_of(td), np_of(jd))


@pytest.mark.parametrize("time_bins", [1, 2, 16])
@pytest.mark.parametrize("dtype,integer", [("float32", True),
                                           ("float32", False),
                                           ("float64", False)])
def test_binned_histograms_box_matches_jax_crop(time_bins, dtype, integer):
    """The ROI box voted directly in the stencil kernels' pitched layout
    (``crop=``, ``pitched=True``) against JAX's full histograms cropped to
    ``_roi_box``: bit-equal on integer coordinates, ≤ 1e-5 abs in float32
    and ≤ 1e-6 relative in float64 on fractional ones."""
    evn = moving_edge_events(2.0, -3.0, n=4000, seed=3)
    if integer:
        evn[:, :2] = np.round(evn[:, :2])
    kw = dict(image_size=(H, W), time_bins=time_bins, warp_radius=2,
              roi=(4, 40, 10, 51))
    jspec, tspec = _specs(dtype, True, **kw)
    jev, tev = _both_events(evn, dtype)
    jh, jd = jcmax.binned_histograms(jev, jspec)
    box = jcmax._roi_box(jspec)
    assert tcmax._roi_box(tspec) == box
    want = np_of(jh)[:, box[0]:box[1], box[2]:box[3]]
    got, td = tcmax.binned_histograms(tev, tspec, crop=box, pitched=True)
    bw = box[3] - box[2]
    pitch = -(-bw // 4) * 4
    assert pitch > bw and got.shape == want.shape
    assert got.dtype == TDT[dtype] and got.stride() == (
        got.shape[1] * pitch, pitch, 1)
    storage = got.as_strided(got.shape[:-1] + (pitch,), got.stride())
    assert not storage[..., bw:].any(), "a pad column is not 0"
    assert np.array_equal(np_of(td), np_of(jd))
    if integer:
        assert np.array_equal(np_of(got), want)
    elif dtype == "float64":
        assert rel_err(got, want) <= 1e-6
    else:
        np.testing.assert_allclose(np_of(got), want, atol=1e-5)
    # the full frame by default, and the box is its crop
    full, _ = tcmax.binned_histograms(tev, tspec)
    assert full.shape == (time_bins, H, W)
    assert torch.equal(full[:, box[0]:box[1], box[2]:box[3]], got)


def _hists_flow(roi, dtype, seed=2):
    """Histograms (box-cropped under an ROI) and a flow over the box."""
    evn = moving_edge_events(2.0, -1.0, n=4000, seed=seed)
    kw = dict(image_size=(H, W), time_bins=4, warp_radius=2, roi=roi)
    jspec, _ = _specs(dtype, False, **kw)
    jev, _ = _both_events(evn, dtype)
    hists, dts = (np_of(a) for a in jcmax.binned_histograms(jev, jspec))
    box = jcmax._roi_box(jspec)
    if box is not None:
        hists = hists[:, box[0]:box[1], box[2]:box[3]]
    rng = np.random.default_rng(seed)
    flow = rng.uniform(-3, 3, (2,) + hists.shape[1:]).astype(hists.dtype)
    return kw, hists, dts, flow


def _iwe_loss_and_grad(side, spec, hists, dts, flow):
    if side == "jax":
        def f(fl):
            iwe = jcmax.binned_iwe(jnp.asarray(hists), jnp.asarray(dts), fl,
                                   spec)
            return jcmax.contrast_loss(iwe, spec), iwe

        (loss, iwe), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jnp.asarray(flow))
        return np_of(iwe), float(loss), np_of(g)
    tf = torch.as_tensor(flow).requires_grad_(True)
    iwe = tcmax.binned_iwe(torch.as_tensor(hists), torch.as_tensor(dts), tf,
                           spec)
    loss = tcmax.contrast_loss(iwe, spec)
    loss.backward()
    return np_of(iwe), float(loss.detach()), np_of(tf.grad)


@pytest.mark.parametrize("roi", [None, (4, 40, 10, 50)])
def test_binned_iwe_stencil_route_matches_jax(roi):
    kw, hists, dts, flow = _hists_flow(roi, "float64")
    jspec, tspec = _specs("float64", False, **kw)
    ji, jl, jg = _iwe_loss_and_grad("jax", jspec, hists, dts, flow)
    ti, tl, tg = _iwe_loss_and_grad("torch", tspec, hists, dts, flow)
    assert ti.shape == ji.shape == ((H, W) if roi is None else (36, 40))
    np.testing.assert_allclose(ti, ji, atol=1e-10)
    assert abs(tl - jl) <= 1e-10 * abs(jl)
    np.testing.assert_allclose(tg, jg, atol=1e-10)


@pytest.mark.parametrize("roi", [None, (4, 40, 10, 50)])
def test_binned_iwe_kernel_route_matches_pallas(roi, pallas_route):
    kw, hists, dts, flow = _hists_flow(roi, "float32")
    jspec, tspec = _specs("float32", True, **kw)
    ji, jl, jg = _iwe_loss_and_grad("jax", jspec, hists, dts, flow)
    ti, tl, tg = _iwe_loss_and_grad("torch", tspec, hists, dts, flow)
    assert ti.shape == ji.shape
    np.testing.assert_allclose(ti, ji, atol=1e-5)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    np.testing.assert_allclose(tg, jg, atol=1e-6)


def test_kink_at_flow_zero(pallas_route):
    """At flow 0 the kernel route's contrast gradient is exactly 0 and the
    stencil route's is not, in the port and in JAX alike."""
    kw, hists, dts, _flow = _hists_flow(None, "float32", seed=3)
    zero = np.zeros((2, H, W), np.float32)
    grads = {}
    for use_kernel in (True, False):
        jspec, tspec = _specs("float32", use_kernel, **kw)
        grads[use_kernel] = (
            _iwe_loss_and_grad("jax", jspec, hists, dts, zero)[2],
            _iwe_loss_and_grad("torch", tspec, hists, dts, zero)[2])
    for g in grads[True]:
        assert not g.any()
    for g in grads[False]:
        assert np.abs(g).max() > 1e-4
    np.testing.assert_allclose(grads[False][1], grads[False][0], atol=1e-6)


@pytest.mark.parametrize("time_bins", [0, 32])
def test_solve_cmax_translation(time_bins):
    evn = moving_edge_events(4.0, -6.0, seed=7)
    jspec, tspec = _specs("float64", False, image_size=(H, W),
                          motion_model="2d-translation", n_iter=60, lr=0.5,
                          time_bins=time_bins)
    jev, tev = _both_events(evn, "float64")
    jm, jres = jcmax.solve_cmax_translation(jev, jax.random.PRNGKey(0),
                                            jspec)
    tm, tres = tcmax.solve_cmax_translation(tev, None, tspec)
    np.testing.assert_allclose(np_of(tm), np_of(jm), atol=1e-8)
    np.testing.assert_allclose(np_of(tres.history), np_of(jres.history),
                               rtol=1e-9)
    assert np.abs(np_of(tm) - [-4.0, 6.0]).max() < 1.5


def test_solve_cmax_translation_bounds_and_methods():
    """Every method family keeps the motion inside the bounds box; the
    dense model takes first-order methods only and raises ``KeyError`` on
    any other name, in both packages."""
    evn = moving_edge_events(6.0, -6.0, n=2000, seed=8)
    jev, tev = _both_events(evn, "float64")
    for method, n_iter in (("Adam", 30), ("BFGS", 6), ("grid", 16),
                           ("Nelder-Mead", 20), ("Newton-CG", 3),
                           ("random", 16), ("TPE", 16)):
        _, tspec = _specs("float64", False, image_size=(H, W),
                          motion_model="2d-translation", n_iter=n_iter,
                          lr=0.5, method=method,
                          param_bounds=((-2.0, 2.0),) * 4)
        m, _ = tcmax.solve_cmax_translation(
            tev, torch.Generator(CPU).manual_seed(0), tspec,
            x0=torch.tensor([0.5, -0.5], dtype=torch.float64))
        assert (np.abs(np_of(m)) <= 2.0 + 1e-12).all(), method
    jspec, tspec = _specs("float64", False, image_size=(H, W),
                          motion_model="dense-flow", n_iter=4,
                          coarsest_patch=32, finest_patch=16,
                          method="BFGS", time_bins=4)
    with pytest.raises(KeyError):
        jcmax.solve_cmax_dense(jev, jax.random.PRNGKey(0), jspec)
    with pytest.raises(KeyError):
        tcmax.solve_cmax_dense(tev, None, tspec)


def _jax_sampler_draws(key, sampler, n, lo, hi):
    """The JAX package's draws of ``run_sampler`` for the 2-D box."""
    k1, k2 = jax.random.split(key)
    n1 = n if sampler == "random" else max(n // 2, 1)
    draws = {"uniform": np.asarray(jax.random.uniform(
        k1, (n1, 2), jnp.float32, jnp.asarray(lo, jnp.float32),
        jnp.asarray(hi, jnp.float32)))}
    if sampler == "TPE":
        n2, n_top = n - n1, max(n1 // 10, 1)
        draws["pick"] = np.asarray(jax.random.randint(k2, (n2,), 0, n_top))
        draws["noise"] = np.asarray(jax.random.normal(
            jax.random.fold_in(k2, 1), (n2, 2), jnp.float32))
    return draws


@pytest.mark.parametrize("method,n_iter", [("random", 48), ("grid", 25),
                                           ("TPE", 48), ("BFGS", 6)])
def test_translation_samplers_and_scipy_methods_match_jax(method, n_iter):
    """The translation model (16 bins) in float64.  The samplers' trials
    are float32 (as in JAX), on the JAX package's draws: the same best trial
    and losses within 1e-9 relative; ``TPE`` is the two-stage stand-in in
    both packages.  ``BFGS`` (L-BFGS) from a shared start within 1e-8."""
    evn = moving_edge_events(4.0, -6.0, n=2000, seed=7)
    jev, tev = _both_events(evn, "float64")
    bounds = ((-8.0, 8.0), (-8.0, 8.0))
    jspec, tspec = _specs("float64", False, image_size=(H, W),
                          motion_model="2d-translation", n_iter=n_iter,
                          method=method, param_bounds=bounds)
    key = jax.random.PRNGKey(3)
    x0 = np.array([-2.0, 3.0])
    draws = (_jax_sampler_draws(key, method, n_iter, [-8.0, -8.0],
                                [8.0, 8.0])
             if method in ("random", "TPE") else None)
    jm, jres = jcmax.solve_cmax_translation(jev, key, jspec,
                                            x0=jnp.asarray(x0))
    tm, tres = tcmax.solve_cmax_translation(tev, None, tspec,
                                            x0=torch.as_tensor(x0),
                                            draws=draws)
    if method == "BFGS":
        np.testing.assert_allclose(np_of(tm), np_of(jm), rtol=0, atol=1e-8)
        np.testing.assert_allclose(np_of(tres.history), np_of(jres.history),
                                   rtol=1e-8)
    else:
        assert tm.dtype == torch.float32
        assert np.array_equal(np_of(tm), np_of(jm))
        np.testing.assert_allclose(np_of(tres.history), np_of(jres.history),
                                   rtol=1e-9)
    # the grid's spacing is 4 px: within half of it
    assert np.abs(np_of(tm) - [-4.0, 6.0]).max() <= 2.0


DENSE = dict(image_size=(H, W), motion_model="dense-flow", coarsest_patch=32,
             finest_patch=16, n_iter=160, lr=0.5, smoothness=0.02,
             time_bins=16, warp_radius=3)


def _dense_both(dtype, use_kernel, **kw):
    evn = moving_edge_events(3.0, -4.0, n=10000, seed=4)
    jspec, tspec = _specs(dtype, use_kernel, **dict(DENSE, **kw))
    jev, tev = _both_events(evn, dtype)
    jflow, jaux = jcmax.estimate_frame_cmax(jev, None, jax.random.PRNGKey(0),
                                            jspec)
    tflow, taux = tcmax.estimate_frame_cmax(tev, None, None, tspec,
                                            device=CPU)
    assert tflow.shape == (2, H, W)
    return np_of(jflow), np_of(tflow), jaux, taux


@pytest.mark.parametrize("kw", [
    {}, {"roi": (0, H, 8, 56), "time_bins": 8, "warp_radius": 2,
         "n_iter": 60},
    {"time_bins": 0, "n_iter": 60}])
def test_solve_cmax_dense_stencil_route_matches_jax(kw):
    jflow, tflow, jaux, taux = _dense_both("float64", False, **kw)
    np.testing.assert_allclose(tflow, jflow, atol=1e-6)
    for a, b in zip(taux["loss_history"], jaux["loss_history"]):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-6)
    if kw.get("time_bins", 16):
        # the flow that sharpens is +v (the warp is x − dt·flow)
        assert abs(np.median(tflow[0]) - 3.0) < 1.5
        assert abs(np.median(tflow[1]) + 4.0) < 1.5


def test_solve_cmax_dense_kernel_route_matches_pallas(pallas_route):
    """A short float32 solve (50 Adam steps): over longer float32 solves
    the two implementations drift apart chaotically on either route, so
    the comparison is short (the long solve is compared in float64)."""
    jflow, tflow, _jaux, _taux = _dense_both(
        "float32", True, n_iter=60, time_bins=4, warp_radius=2)
    assert np.isfinite(tflow).all()
    np.testing.assert_allclose(tflow, jflow, atol=5e-4)
    assert abs(np.median(tflow[0]) - 3.0) < 1.5
    assert abs(np.median(tflow[1]) + 4.0) < 1.5


def test_estimate_frame_cmax_translation_model():
    evn = moving_edge_events(2.0, 2.0, seed=5)
    jspec, tspec = _specs("float64", False, image_size=(H, W),
                          motion_model="2d-translation", n_iter=40, lr=0.5)
    jev, tev = _both_events(evn, "float64")
    jflow, _ = jcmax.estimate_frame_cmax(jev, None, jax.random.PRNGKey(0),
                                         jspec)
    tflow, aux = tcmax.estimate_frame_cmax(tev, None, None, tspec,
                                           device=CPU)
    assert tflow.shape == (2, H, W)
    np.testing.assert_allclose(np_of(tflow), np_of(jflow), atol=1e-8)
    np.testing.assert_allclose(np_of(tflow[:, 0, 0]), -np_of(aux["motion"]))
    with pytest.raises(KeyError):
        tcmax.estimate_frame_cmax(tev, None, None, tcmax.CmaxSpec(
            image_size=(H, W), motion_model="affine"), device=CPU)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_bench_like_scene_returns_the_start(use_kernel):
    """A reduced copy of the bench scene (its generator at 90×160 with
    8,000 events, the plume speed scaled with the height) under the CMax
    cell's spec (``CmaxSpec``'s defaults with the bench ROI's proportions;
    60 Adam steps to keep it short): the iterates leave flow 0 at every
    scale, but no step beats the contrast at flow 0, so on both routes the
    solve returns flow exactly 0.  The scene's displacement is a static
    refraction field, not motion over the window."""
    from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                          generate_sequence)

    h, w = 90, 160
    seq = generate_sequence(SyntheticBosConfig(
        height=h, width=w, duration=1.0 / 30.0, fps=30.0,
        events_per_frame=8000, max_displacement=3.0,
        plume_speed=900.0 * h / 720, seed=0))
    evn = seq["events"]
    evn[:, 2] += 10.0
    assert np.array_equal(evn[:, :2], np.round(evn[:, :2]))
    spec = tcmax.CmaxSpec(image_size=(h, w), roi=(0, h, w // 4, 3 * w // 4),
                          n_iter=60, use_kernel=use_kernel)
    tev = ttypes.events_from_ndarray(evn, device=CPU)
    flow, aux = tcmax.estimate_frame_cmax(tev, None, None, spec, device=CPU)
    assert flow.shape == (2, h, w)
    assert not flow.any()
    for hist in (np_of(x) for x in aux["loss_history"]):
        assert (hist != hist[0]).any()
        assert hist.min() >= hist[0]
