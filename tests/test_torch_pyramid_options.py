"""The pyramid's options in the port against the JAX package's: the
ROI-restricted objective and solve, the multi-start and the compute dtypes.

Both packages get the same small synthetic scene (64×96), the same IWE
cache (made by the JAX package) and the same init (random streams differ
between the frameworks).  Tolerances, float64 unless stated:

* the full-frame TV and Charbonnier forms and ``outside_norm_sq`` at
  stride 1: 1e-12 relative;
* the restricted ``dense_objective`` (``roi_crop`` + outside strips) value
  and gradient: 1e-10 relative, for an ROI spanning the full height (only
  the flanks form strips, merged into one grid, as at the bench's ROI) and
  one open on all four sides, with and without the event-hist weights;
* the restricted solve and each multi-start lane: 1e-6 px, with +0.0
  outside the ROI;
* bfloat16 (``compute_dtype`` and ``warp_compute_bf16``): the objective's
  value within 1e-3 and its gradient within 2e-2 relative (norm of the
  difference over the norm; measured: ≤ 6.1e-5 and ≤ 3.8e-3.  XLA may fuse
  bfloat16 chains without rounding between the ops, torch rounds after
  each, so no bitwise parity exists), and a bfloat16 solve correlating
  ≥ 0.98 with the port's own float32 solve from the same init over the
  ROI (measured 0.9991 for ``compute_dtype``, 0.99999 for the warp alone);
* a float32 interior under float64 parameters: 1e-6 px (measured 6.6e-8).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.costs as jcosts
import event_based_bos_tpu.ops.gradients as jgrads
import event_based_bos_tpu.solver.generative as jgen
import event_based_bos_tpu.solver.pyramid as jpyr
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.costs as tcosts
import event_based_bos_tpu_torch.solver.generative as tgen
import event_based_bos_tpu_torch.solver.pyramid as tpyr
from torch_parity import CPU, np_of, small_scene, torch_threads

H, W = 64, 96
CELL_ROI = (0, H, 16, 80)     # full height, as the bench's (0, 720, 320, 960)
BOX_ROI = (12, 52, 20, 76)    # open on all four sides
HOT_PLATE_COSTS = (("diff_norm", 1.0), ("image_gradient", 0.5),
                   ("flow_norm_pxy", 0.1))
TDT = {"float32": torch.float32, "float64": torch.float64,
       "bfloat16": torch.bfloat16, None: None}
JDT = {"float32": jnp.float32, "float64": jnp.float64,
       "bfloat16": jnp.bfloat16, None: None}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _specs(dtype="float64", roi=CELL_ROI, n_iter=24, compute=None, gen_kw=(),
           **pkw):
    kw = dict(image_size=(H, W), iwe_sigma=2.0,
              weight_by_inverse_event_hist=True, optimize_warp=True,
              poisson_model=True, cost_weights=HOT_PLATE_COSTS)
    kw.update(dict(gen_kw))
    pkw = dict(dict(roi=roi, coarsest_patch=16, finest_patch=8,
                    n_iter=n_iter), **pkw)
    jspec = jpyr.PyramidSpec(gen=jgen.GenerativeSpec(
        dtype=JDT[dtype], compute_dtype=JDT[compute], **kw), **pkw)
    tspec = tpyr.PyramidSpec(gen=tgen.GenerativeSpec(
        dtype=TDT[dtype], compute_dtype=TDT[compute], **kw), **pkw)
    return jspec, tspec


@functools.lru_cache(maxsize=None)
def _inputs(dtype="float64", event_weights=False):
    """Frame, the JAX-made IWE cache and a numpy coarsest init."""
    jspec, _ = _specs(dtype, gen_kw=(("weight_by_event_hist",
                                      event_weights),))
    events, frame, _gt = small_scene(H, W)
    jev = jtypes.events_from_ndarray(events, capacity=4096)
    cache = tuple(None if c is None else np.asarray(c)
                  for c in jgen.iwe_cache(jev, jspec.gen))
    init = np.zeros((3, H // 16, W // 16), dtype)
    init[0] = np.random.default_rng(7).uniform(-1, 1, init.shape[1:])
    return frame.astype(dtype), cache, init


def _jax_estimate(jspec, frame, cache, init):
    fn = jax.jit(functools.partial(jpyr.estimate_frame, spec=jspec))
    return fn(None, jnp.asarray(frame), jnp.asarray(jpyr.roi_mask(jspec)),
              jax.random.PRNGKey(0), init_params=jnp.asarray(init),
              cache=tuple(None if c is None else jnp.asarray(c)
                          for c in cache))


def _torch_estimate(tspec, frame, cache, init, generator=None):
    return tpyr.estimate_frame(None, frame, tpyr.roi_mask(tspec), generator,
                               tspec, init_params=init, cache=cache,
                               device=CPU)


def _rel(a, b):
    a, b = np_of(a).astype(np.float64), np_of(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


def _corr(a, b, roi):
    x0, x1, y0, y1 = roi
    a = np_of(a)[:, x0:x1, y0:y1].astype(np.float64).ravel()
    b = np_of(b)[:, x0:x1, y0:y1].astype(np.float64).ravel()
    return float(np.corrcoef(a, b)[0, 1])


def _outside(roi):
    out = np.ones((H, W), bool)
    out[roi[0]:roi[1], roi[2]:roi[3]] = False
    return out


# ---------------------------------------------------------------------------
# The cost forms and the outside correction
# ---------------------------------------------------------------------------

def test_full_domain_tv_and_charbonnier_match_jax():
    rng = np.random.default_rng(0)
    flow = rng.normal(size=(2, 40, 50))
    flow[:, [0, -1], :] = 0.0
    flow[:, :, [0, -1]] = 0.0
    pred, meas = rng.normal(size=(2, 40, 50))
    for full in (None, (H, W)):
        arg = {"flow": flow, "prediction": pred, "measurement": meas}
        if full is not None:
            arg["full_domain"] = full
        jarg = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                for k, v in arg.items()}
        targ = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
                for k, v in arg.items()}
        for name in ("total_variation", "charbonnier"):
            want = float(jcosts.functions[name](jarg))
            got = float(tcosts.functions[name](targ))
            assert abs(got - want) <= 1e-12 * abs(want), (name, full)
    # the full-frame form from the box equals the plain form on the frame
    # when the field is zero outside the box
    big = np.zeros((2, H, W))
    big[:, 5:45, 10:60] = flow
    d = rng.normal(size=(H, W)) * 0
    d[5:45, 10:60] = pred - meas
    crop = {"flow": torch.as_tensor(flow), "full_domain": (H, W),
            "prediction": torch.as_tensor(pred - meas),
            "measurement": torch.zeros(40, 50, dtype=torch.float64)}
    whole = {"flow": torch.as_tensor(big), "prediction": torch.as_tensor(d),
             "measurement": torch.zeros(H, W, dtype=torch.float64)}
    for name in ("total_variation", "charbonnier"):
        a = float(tcosts.functions[name](crop))
        b = float(tcosts.functions[name](whole))
        assert abs(a - b) <= 1e-12 * abs(b), name


def test_outside_norm_sq_at_stride_one_matches_jax():
    jspec, tspec = _specs(roi=BOX_ROI, restrict_to_roi=True)
    rng = np.random.default_rng(1)
    gx, gy = rng.normal(size=(2, H, W))
    grid = tpyr.pyramid_grids(tspec)[-1]
    patch_flow = rng.normal(size=(2,) + grid.shape)
    crop = tpyr.roi_crop_box(tspec)
    jstrips = jpyr._outside_strips(crop, jnp.asarray(gx), jnp.asarray(gy),
                                   jspec.gen, 1)
    tstrips = tpyr._outside_strips(crop, torch.as_tensor(gx),
                                   torch.as_tensor(gy), tspec.gen, 1)
    assert len(tstrips) == len(jstrips) == 3
    for a, b in zip(tstrips, jstrips):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    want = float(jgen.outside_norm_sq(jnp.asarray(patch_flow), grid,
                                      jspec.gen, jstrips))
    got = float(tgen.outside_norm_sq(torch.as_tensor(patch_flow), grid,
                                     tspec.gen, tstrips))
    assert abs(got - want) <= 1e-12 * abs(want)
    # at stride 1 it is the exact squared norm of flow·∇I outside the box
    dense = np_of(tgen.patch_to_dense(torch.as_tensor(patch_flow), grid))
    q = (dense[0] * gx + dense[1] * gy) ** 2
    assert abs(got - q[_outside(crop)].sum()) <= 1e-12 * got


def test_cell_roi_merges_the_flanks_into_one_strip():
    _, tspec = _specs(roi=CELL_ROI, restrict_to_roi=True)
    crop = tpyr.roi_crop_box(tspec)
    assert crop == (0, H, 14, 82)
    g = torch.ones(H, W, dtype=torch.float64)
    (strip,) = tpyr._outside_strips(crop, g, g, tspec.gen, 4)
    rows, cols = strip[0], strip[1]
    assert np.array_equal(rows, np.arange(2, H, 4))
    assert np.array_equal(cols, np.r_[np.arange(2, 14, 4),
                                      np.arange(84, W, 4)])
    assert strip[5] == 16.0


# ---------------------------------------------------------------------------
# The restricted objective and solve
# ---------------------------------------------------------------------------

def _objective_pair(roi, event_weights, dtype="float64", compute=None,
                    warp_bf16=False, stride=4):
    """The restricted objective in both packages on the same inputs:
    ``(jax value_and_grad, torch value and grad)``."""
    gk = (("weight_by_event_hist", event_weights),
          ("warp_compute_bf16", warp_bf16))
    jspec, tspec = _specs(dtype, roi=roi, compute=compute, gen_kw=gk,
                          restrict_to_roi=True, roi_norm_stride=stride)
    frame, cache, _init = _inputs(dtype, event_weights)
    hist, weights, wi = cache
    jgx, jgy = jgrads.frame_gradients(jnp.asarray(frame))
    gx, gy = np.asarray(jgx), np.asarray(jgy)
    mask = jpyr.roi_mask(jspec)
    crop = tpyr.roi_crop_box(tspec)
    x0, x1, y0, y1 = crop
    area = (x1 - x0) * (y1 - y0) / (H * W)
    grid = tpyr.pyramid_grids(tspec)[1]
    rng = np.random.default_rng(3)
    params = rng.uniform(-0.5, 0.5, (3,) + grid.shape).astype(dtype)
    weights_np = None if weights is None else np.asarray(weights)

    def crop_(a):
        return None if a is None else a[x0:x1, y0:y1]

    # JAX: the restricted branch of its solve_pyramid, spelled out
    jg = dataclasses.replace(jspec.gen, cost_weights=tuple(
        (n, w * area if n in ("image_gradient", "flow_norm",
                              "flow_norm_pxy") else w)
        for n, w in jspec.gen.cost_weights))
    jmeas = np.asarray(jgen.measured_increment(
        jnp.asarray(hist), None if weights is None
        else jnp.asarray(weights))) * mask
    jstrips = jpyr._outside_strips(crop, jgx, jgy, jg, stride,
                                   weights=None if weights is None
                                   else jnp.asarray(weights))
    cd = JDT[compute] or JDT[dtype]
    jargs = [jnp.asarray(crop_(a)).astype(cd)
             for a in (jmeas, gx, gy, wi, mask)]
    jw = None if weights is None else jnp.asarray(crop_(weights_np)).astype(cd)

    def jobj(p):
        return jgen.dense_objective(p, *jargs[:3], jargs[3], jargs[4], grid,
                                    jg, weights=jw, roi_crop=crop,
                                    norm_strips=jstrips)

    (jloss, jterms), jgrad = jax.jit(jax.value_and_grad(jobj, has_aux=True))(
        jnp.asarray(params))

    # the port: its own helpers
    tg = dataclasses.replace(tspec.gen, cost_weights=tpyr._restricted_weights(
        tspec.gen.cost_weights, area))
    assert tg.cost_weights == jg.cost_weights
    tt = {k: None if v is None else torch.as_tensor(v)
          for k, v in (("gx", gx), ("gy", gy), ("w", weights_np))}
    tstrips = tpyr._outside_strips(crop, tt["gx"], tt["gy"], tg, stride,
                                   weights=tt["w"])
    tmeas = tgen.measured_increment(torch.as_tensor(hist), tt["w"]) \
        * torch.as_tensor(mask)
    tcd = TDT[compute] or TDT[dtype]
    targs = [torch.as_tensor(np.asarray(crop_(np_of(a)))).to(tcd)
             for a in (tmeas, gx, gy, wi, mask)]
    tw = None if tt["w"] is None else crop_(tt["w"]).to(tcd)
    p = torch.as_tensor(params).requires_grad_(True)
    tloss, tterms = tgen.dense_objective(p, *targs[:3], targs[3], targs[4],
                                         grid, tg, weights=tw, roi_crop=crop,
                                         norm_strips=tstrips)
    (tgrad,) = torch.autograd.grad(tloss, p)
    return (jloss, jterms, jgrad), (tloss.detach(), tterms, tgrad)


@pytest.mark.parametrize("event_weights", [False, True])
@pytest.mark.parametrize("roi", [CELL_ROI, BOX_ROI], ids=["cell", "box"])
def test_restricted_objective_value_and_gradient_match_jax(roi,
                                                           event_weights):
    (jl, jt, jg), (tl, tt, tg) = _objective_pair(roi, event_weights)
    assert abs(float(tl) - float(jl)) <= 1e-10 * abs(float(jl))
    for k in jt:
        assert abs(float(tt[k]) - float(jt[k])) <= 1e-10 * abs(float(jt[k]))
    assert _rel(tg, jg) <= 1e-10
    assert float(np.abs(np_of(tg)).max()) > 0


@pytest.fixture(scope="module")
def restricted_solves():
    """Restricted float64 solves in both packages from the pinned init."""
    out = {}
    for roi, name in ((CELL_ROI, "cell"), (BOX_ROI, "box")):
        for ew in (False, True):
            jspec, tspec = _specs(roi=roi, restrict_to_roi=True,
                                  gen_kw=(("weight_by_event_hist", ew),))
            frame, cache, init = _inputs("float64", ew)
            out[name, ew] = (_jax_estimate(jspec, frame, cache, init),
                             _torch_estimate(tspec, frame, cache, init))
    return out


@pytest.mark.parametrize("event_weights", [False, True])
@pytest.mark.parametrize("roi", [CELL_ROI, BOX_ROI], ids=["cell", "box"])
def test_restricted_solve_matches_jax(restricted_solves, roi, event_weights):
    name = "cell" if roi == CELL_ROI else "box"
    (jflow, jaux), (tflow, taux) = restricted_solves[name, event_weights]
    np.testing.assert_allclose(np_of(tflow), np_of(jflow), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_of(taux["pxy"]), np_of(jaux["pxy"]),
                               rtol=0, atol=1e-6)
    for a, b in zip(taux["loss_history"], jaux["loss_history"]):
        assert _rel(a, b) <= 1e-9
    flow = np_of(tflow)
    out = _outside(roi)
    assert (flow[:, out] == 0).all() and not np.signbit(flow[:, out]).any()
    assert np.array_equal(np.signbit(flow), np.signbit(np_of(jflow)))
    assert (np_of(taux["pxy"])[:, out] == 0).all()
    assert np.abs(flow[:, ~out]).max() > 0


def _first_loss_and_corr(cost_weights, stride=4, n_iter=40):
    """The port's full-frame and restricted float32 solves from one init:
    the first loss of each and the correlation of the flows over the ROI."""
    kw = dict(gen_kw=(("cost_weights", cost_weights),), n_iter=n_iter)
    _, full = _specs("float32", **kw)
    fast = dataclasses.replace(full, restrict_to_roi=True,
                               roi_norm_stride=stride)
    frame, cache, init = _inputs("float32")
    f_full, a_full = _torch_estimate(full, frame, cache, init)
    f_fast, a_fast = _torch_estimate(fast, frame, cache, init)
    l0 = [float(a["loss_history"][0][0]) for a in (a_full, a_fast)]
    return l0, _corr(f_full, f_fast, CELL_ROI)


@pytest.mark.parametrize("cost_weights", [
    HOT_PLATE_COSTS,
    (("diff_norm", 1.0), ("image_gradient", "inv"), ("flow_norm_pxy", 0.1)),
    (("diff_norm", 1.0), ("total_variation", 5.0), ("charbonnier", 2.0)),
], ids=["hot_plate", "inv", "tv_charbonnier"])
def test_restricted_solve_keeps_the_full_frame_objective(cost_weights):
    """As the JAX package's tests require of its restricted mode: the first
    loss within 5 % of the full-frame one from the same init, and the flows
    correlated > 0.97 (> 0.95 for the reweighted costs) over the ROI."""
    (l_full, l_fast), corr = _first_loss_and_corr(cost_weights)
    assert abs(l_fast - l_full) <= 0.05 * abs(l_full), (l_full, l_fast)
    assert corr > (0.97 if cost_weights == HOT_PLATE_COSTS else 0.95), corr


def test_restricted_stride_one_reproduces_the_full_frame_loss():
    (l_full, l_fast), _corr_ = _first_loss_and_corr(HOT_PLATE_COSTS, 1, 8)
    assert abs(l_fast - l_full) <= 1e-5 * abs(l_full), (l_full, l_fast)


def test_restricted_plain_velocity_model_is_finite():
    """The plain (vx, vy) model starts at a prediction of exactly zero, and
    the outside correction is zero too: the norm's guard keeps iteration 0
    from back-propagating NaN."""
    gk = (("optimize_warp", False), ("poisson_model", False),
          ("weight_by_inverse_event_hist", False),
          ("cost_weights", (("diff_norm", 1.0), ("image_gradient", 0.5),
                            ("flow_norm", 0.1))))
    _, tspec = _specs("float32", n_iter=12, gen_kw=gk, restrict_to_roi=True)
    frame, _cache, _init = _inputs("float32")
    events, _frame, _gt = small_scene(H, W)
    from event_based_bos_tpu_torch.types import events_from_ndarray

    ev = events_from_ndarray(events, capacity=4096, device=CPU)
    flow, aux = tpyr.estimate_frame(ev, frame, tpyr.roi_mask(tspec), None,
                                    tspec, device=CPU)
    assert np.isfinite(np_of(flow)).all()
    for hist in aux["loss_history"]:
        assert np.isfinite(np_of(hist)).all()


# ---------------------------------------------------------------------------
# Multi-start
# ---------------------------------------------------------------------------

R = 3


@functools.lru_cache(maxsize=None)
def _lanes(track_best):
    """Each lane's init (drawn as the port draws them), its JAX solve and
    its port solve, float64."""
    jspec, tspec = _specs(track_best=track_best)
    frame, cache, _init = _inputs("float64")
    g = torch.Generator(CPU).manual_seed(5)
    shape = tpyr.pyramid_grids(tspec)[0].shape
    inits = [np_of(tgen.initialize_params(g, shape, tspec.gen, CPU))
             for _ in range(R)]
    jsolve = jax.jit(functools.partial(jpyr.solve_pyramid, spec=jspec))
    hist, weights, wi = (None if c is None else jnp.asarray(c)
                         for c in cache)
    jgx, jgy = jgrads.frame_gradients(jnp.asarray(frame))
    jmask = jnp.asarray(jpyr.roi_mask(jspec))
    jlanes = [jsolve(hist, weights, wi, jgx, jgy, jmask,
                     jax.random.PRNGKey(0), init_params=jnp.asarray(x0))
              for x0 in inits]
    tlanes = [_torch_estimate(tspec, frame, cache, x0) for x0 in inits]
    return inits, jlanes, tlanes


@pytest.mark.parametrize("restart_mode", ["map", "vmap"])
@pytest.mark.parametrize("track_best", [True, False])
def test_multistart_returns_the_best_lane(track_best, restart_mode):
    inits, jlanes, tlanes = _lanes(track_best)
    for (jf, ja), (tf, ta) in zip(jlanes, tlanes):
        np.testing.assert_allclose(np_of(tf), np_of(jf), rtol=0, atol=1e-6)
    jhist = [np.asarray(a["loss_history"][-1]) for _f, a in jlanes]
    jscore = [h.min() if track_best else h[-1] for h in jhist]
    tscore = np_of(tpyr.restart_scores(tlanes, track_best))
    np.testing.assert_allclose(tscore, jscore, rtol=1e-9)
    best = int(np.argmin(tscore))
    assert best == int(np.argmin(jscore))

    _, tspec = _specs(track_best=track_best, n_restarts=R,
                      restart_mode=restart_mode)
    frame, cache, _init = _inputs("float64")
    g = torch.Generator(CPU).manual_seed(5)
    flow, aux = _torch_estimate(tspec, frame, cache, None, generator=g)
    bflow, baux = tlanes[best]
    assert torch.equal(flow, bflow)
    assert torch.equal(aux["pxy"], baux["pxy"])
    for a, b in zip(aux["params_per_scale"], baux["params_per_scale"]):
        assert torch.equal(a, b)
    for a, b in zip(aux["loss_history"], baux["loss_history"]):
        assert torch.equal(a, b)
    # the generator drew the R inits in lane order, nothing more
    g2 = torch.Generator(CPU).manual_seed(5)
    for x0 in inits:
        tgen.initialize_params(g2, x0.shape[1:], tspec.gen, CPU)
    assert torch.equal(g.get_state(), g2.get_state())


def test_multistart_is_skipped_when_the_init_is_pinned():
    _, tspec = _specs(n_iter=8, n_restarts=R)
    frame, cache, init = _inputs("float64")
    g = torch.Generator(CPU).manual_seed(5)
    state = g.get_state()
    flow, _ = _torch_estimate(tspec, frame, cache, init, generator=g)
    single, _ = _torch_estimate(dataclasses.replace(tspec, n_restarts=1),
                                frame, cache, init)
    assert torch.equal(flow, single)
    assert torch.equal(g.get_state(), state)


def test_multistart_rejects_an_unknown_restart_mode():
    _, tspec = _specs(n_iter=8, n_restarts=R, restart_mode="pmap")
    frame, cache, _init = _inputs("float64")
    with pytest.raises(ValueError, match="restart_mode"):
        _torch_estimate(tspec, frame, cache, None,
                        generator=torch.Generator(CPU).manual_seed(0))


# ---------------------------------------------------------------------------
# Compute dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["compute_dtype", "warp_compute_bf16",
                                  "restricted_bf16"])
def test_bf16_objective_matches_jax(mode):
    roi = CELL_ROI
    compute = None if mode == "warp_compute_bf16" else "bfloat16"
    stride = 4 if mode == "restricted_bf16" else 0
    if mode == "restricted_bf16":
        (jl, _jt, jg), (tl, _tt, tg) = _objective_pair(
            roi, False, "float32", compute=compute, stride=stride)
    else:
        jl, jg, tl, tg = _full_objective_pair(
            compute, warp_bf16=mode == "warp_compute_bf16")
    assert tl.dtype == torch.float32 and tg.dtype == torch.float32
    assert abs(float(tl) - float(jl)) <= 1e-3 * abs(float(jl))
    assert _rel(tg, jg) <= 2e-2


def _full_objective_pair(compute, warp_bf16):
    """The full-frame float32 objective with a bfloat16 interior or warp."""
    gk = (("warp_compute_bf16", warp_bf16),)
    jspec, tspec = _specs("float32", compute=compute, gen_kw=gk)
    frame, cache, _init = _inputs("float32")
    hist, _w, wi = cache
    jgx, jgy = jgrads.frame_gradients(jnp.asarray(frame))
    mask = jpyr.roi_mask(jspec)
    meas = np.asarray(jgen.measured_increment(jnp.asarray(hist), None)) * mask
    grid = tpyr.pyramid_grids(tspec)[1]
    params = np.random.default_rng(3).uniform(
        -0.5, 0.5, (3,) + grid.shape).astype(np.float32)
    cd = JDT[compute] or jnp.float32
    jargs = [jnp.asarray(a).astype(cd)
             for a in (meas, np.asarray(jgx), np.asarray(jgy), wi, mask)]

    def jobj(p):
        return jgen.dense_objective(p, *jargs, grid, jspec.gen)[0]

    jl, jg = jax.jit(jax.value_and_grad(jobj))(jnp.asarray(params))
    tcd = TDT[compute] or torch.float32
    targs = [torch.as_tensor(np.asarray(a)).to(tcd)
             for a in (meas, np.asarray(jgx), np.asarray(jgy), wi, mask)]
    p = torch.as_tensor(params).requires_grad_(True)
    tl, _ = tgen.dense_objective(p, *targs, grid, tspec.gen)
    (tg,) = torch.autograd.grad(tl, p)
    return jl, jg, tl.detach(), tg


@pytest.mark.parametrize("mode", ["compute_dtype", "warp_compute_bf16",
                                  "restricted_bf16"])
def test_bf16_solve_correlates_with_float32(mode):
    pkw = {"restrict_to_roi": True} if mode == "restricted_bf16" else {}
    gk = (("warp_compute_bf16", mode == "warp_compute_bf16"),)
    compute = None if mode == "warp_compute_bf16" else "bfloat16"
    _, t32 = _specs("float32", n_iter=40, **pkw)
    _, tbf = _specs("float32", n_iter=40, compute=compute, gen_kw=gk, **pkw)
    frame, cache, init = _inputs("float32")
    f32, _ = _torch_estimate(t32, frame, cache, init)
    fbf, aux = _torch_estimate(tbf, frame, cache, init)
    assert fbf.dtype == torch.float32
    assert aux["params_per_scale"][-1].dtype == torch.float32
    assert np.isfinite(np_of(fbf)).all()
    out = _outside(CELL_ROI)
    assert (np_of(fbf)[:, out] == 0).all()
    assert _corr(fbf, f32, CELL_ROI) >= 0.98


def test_float32_interior_at_float64_matches_jax():
    """``compute_dtype: float32`` under ``precision: 64``: float64
    parameters and optimizer, a float32 interior — the JAX package's solve
    from the same init within 1e-6 px."""
    jspec, tspec = _specs("float64", compute="float32", n_iter=24)
    frame, cache, init = _inputs("float64")
    jflow, jaux = _jax_estimate(jspec, frame, cache, init)
    tflow, taux = _torch_estimate(tspec, frame, cache, init)
    assert tflow.dtype == torch.float64
    assert taux["params_per_scale"][-1].dtype == torch.float64
    np.testing.assert_allclose(np_of(tflow), np_of(jflow), rtol=0, atol=1e-6)
    _, t64 = _specs("float64", n_iter=24)
    f64, _ = _torch_estimate(t64, frame, cache, init)
    assert not torch.equal(f64, tflow)  # the interior really was float32
