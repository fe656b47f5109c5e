"""The port's whole-ROI (GML) solver against the JAX package's.

* The scalar objective (``solver/generative.py``) and
  ``unfold_scalar_params``, value and gradient within 1e-12 in float64, for
  each parameter model: the plain and angle models with the warp pair, the
  poisson model with the warp pair (3 parameters; JAX clamps the read of
  ``theta[2:][1]`` and drops its gradient), ``pxpy_as_anglemagn``,
  ``no_polarity``, event-hist weights and the gather warp (radius 0).
* ``estimate_frame_gml`` on the small synthetic scene (64×96, float64) from
  one ``x0`` for every optimizer family, within 1e-10; the samplers on
  float32 trials (the box is float32 in a float64 solve, as in JAX: the
  cost terms of the constant flow and translation are then float32 means
  over the ROI's 4,096 pixels, whose summation order differs: within 1e-5
  relative), the random draws passed in.
* The host-driven TPE study from one seed: the same proposals, so the same
  parameters bit for bit.
* The DEBUG evolution video of the facade, against the JAX facade's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.solver.generative as jgen
import event_based_bos_tpu.solver.gml as jgml
import event_based_bos_tpu_torch.solver.generative as tgen
import event_based_bos_tpu_torch.solver.gml as tgml
from torch_parity import (CPU, both_events, np_of, small_scene,
                          torch_threads)

H, W = 64, 96
ROI = (0, H, 16, 80)
NO_PXY = (("diff_norm", 1.0), ("image_gradient", 0.5))

MODELS = {
    "plain_warp": dict(poisson_model=False, optimize_warp=True),
    "angle_warp": dict(angle_model=True, poisson_model=False,
                       optimize_warp=True),
    "poisson_warp": dict(poisson_model=True, optimize_warp=True),
    "poisson": dict(poisson_model=True, optimize_warp=False,
                    cost_weights=NO_PXY),
    "anglemagn": dict(poisson_model=False, optimize_warp=True,
                      pxpy_as_anglemagn=True),
    "no_polarity": dict(poisson_model=False, optimize_warp=True,
                        no_polarity=True),
    "gather_warp": dict(poisson_model=False, optimize_warp=True,
                        warp_stencil_radius=0),
}
THETA = {"plain_warp": [0.3, -0.2, 0.1, 0.05],
         "angle_warp": [2.5, 0.1, -0.2], "poisson_warp": [0.3, -0.2, 0.15],
         "poisson": [0.4], "anglemagn": [0.3, -0.2, 0.2, 1.1],
         "no_polarity": [0.3, -0.2, 0.1, 0.05],
         "gather_warp": [0.3, -0.2, 0.6, -1.3]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _gens(model, **extra):
    kw = dict(image_size=(H, W), iwe_sigma=2.0,
              weight_by_inverse_event_hist=True, **MODELS[model])
    kw.update(extra)
    return (jgen.GenerativeSpec(dtype=jnp.float64, **kw),
            tgen.GenerativeSpec(dtype=torch.float64, **kw))


def _constants(weights=False):
    rng = np.random.default_rng(11)
    gx, gy, wi = (rng.normal(size=(H, W)) for _ in range(3))
    x0, x1, y0, y1 = ROI
    m = rng.normal(size=(x1 - x0, y1 - y0))
    w = rng.uniform(0.5, 1.5, (x1 - x0, y1 - y0)) if weights else None
    return m / np.linalg.norm(m), gx, gy, wi, w


@pytest.mark.parametrize("model", list(MODELS) + ["weights"])
def test_scalar_objective_value_and_gradient(model):
    weights = model == "weights"
    name = "plain_warp" if weights else model
    jspec, tspec = _gens(name)
    m, gx, gy, wi, w = _constants(weights)
    theta = np.asarray(THETA[name])

    jargs = [None if a is None else jnp.asarray(a)
             for a in (m, gx, gy, wi, w)]

    def jloss(t):
        return jgen.scalar_objective(t, *jargs[:4], ROI, jspec,
                                     weights_roi=jargs[4])[0]

    jv, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(theta))
    t = torch.tensor(theta, requires_grad=True)
    args = [None if a is None else torch.as_tensor(a)
            for a in (m, gx, gy, wi, w)]
    tv, terms = tgen.scalar_objective(t, *args[:4], ROI, tspec,
                                      weights_roi=args[4])
    (tg,) = torch.autograd.grad(tv, t)
    assert abs(float(tv.detach()) - float(jv)) <= 1e-12
    np.testing.assert_allclose(np_of(tg), np_of(jg), rtol=0, atol=1e-12)
    assert set(terms) == {n for n, _w in tspec.cost_weights}


@pytest.mark.parametrize("model", list(MODELS))
def test_unfold_scalar_params(model):
    jspec, tspec = _gens(model)
    theta = np.asarray(THETA[model])
    jv = jgen.unfold_scalar_params(jnp.asarray(theta), jspec)
    tv = tgen.unfold_scalar_params(torch.as_tensor(theta), tspec)
    flat = [jv[0], jv[1]] + ([] if jv[2] is None else list(jv[2]))
    tflat = [tv[0], tv[1]] + ([] if tv[2] is None else list(tv[2]))
    assert len(flat) == len(tflat)
    for a, b in zip(tflat, flat):
        assert abs(float(a) - float(b)) <= 1e-15
    if model == "poisson_warp":
        # the clamped read: the warp pair is (theta[2], theta[2])
        assert float(tv[2][0]) == float(tv[2][1]) == theta[2]


def _spec_pair(model, method, n_iter, **kw):
    jgen_, tgen_ = _gens(model)
    bounds = ((-3.0, 3.0),) * jgen_.param_dim
    return (jgml.GmlSpec(gen=jgen_, roi=ROI, method=method, n_iter=n_iter,
                         param_bounds=bounds, **kw),
            tgml.GmlSpec(gen=tgen_, roi=ROI, method=method, n_iter=n_iter,
                         param_bounds=bounds, **kw))


def _scene():
    events, frame, _gt = small_scene()
    fields = tuple(events[:, i].astype(np.float64) for i in range(4))
    jev, tev = both_events(fields)
    return jev, tev, frame.astype(np.float64)


def _jax_solve(jev, frame, spec, x0=None, key=0):
    def run(e, f):
        flow, aux = jgml.estimate_frame_gml(e, f, jax.random.PRNGKey(key),
                                            spec, x0=x0)
        return flow, aux["history"], aux["theta"], aux.get("theta_history")

    return jax.jit(run)(jev, jnp.asarray(frame))


@pytest.mark.parametrize("method,n_iter", [
    ("Adam", 40), ("RMSprop", 30), ("BFGS", 10), ("Nelder-Mead", 50),
    ("Newton-CG", 5)])
def test_estimate_frame_gml_matches_jax(method, n_iter):
    jev, tev, frame = _scene()
    jspec, tspec = _spec_pair("plain_warp", method, n_iter)
    x0 = np.array([0.1, -0.1, 0.0, 0.0])
    jflow, jhist, jtheta, _ = _jax_solve(jev, frame, jspec, jnp.asarray(x0))
    tflow, aux = tgml.estimate_frame_gml(tev, frame, None, tspec, x0=x0,
                                         device=CPU)
    assert tflow.shape == (2, H, W) and tflow.dtype == torch.float64
    np.testing.assert_allclose(np_of(aux["theta"]), np_of(jtheta), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(np_of(aux["history"]), np_of(jhist), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(np_of(tflow), np_of(jflow), rtol=0,
                               atol=1e-10)
    assert float(aux["history"][-1]) < float(aux["history"][0])


def test_clamped_poisson_warp_model_solves_as_in_jax():
    """``configs/hot_plate1.yaml``'s ``generative_ml`` section (poisson
    model with ``optimize_warp``): 3 parameters, the warp pair read through
    JAX's clamped index."""
    jev, tev, frame = _scene()
    jspec, tspec = _spec_pair("poisson_warp", "Adam", 40)
    x0 = np.array([0.2, -0.3, 0.05])
    jflow, jhist, jtheta, _ = _jax_solve(jev, frame, jspec, jnp.asarray(x0))
    tflow, aux = tgml.estimate_frame_gml(tev, frame, None, tspec, x0=x0,
                                         device=CPU)
    np.testing.assert_allclose(np_of(aux["theta"]), np_of(jtheta), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(np_of(aux["history"]), np_of(jhist), rtol=0,
                               atol=1e-10)


def test_record_evolution_matches_jax():
    jev, tev, frame = _scene()
    jspec, tspec = _spec_pair("plain_warp", "Adam", 12, record_evolution=4)
    x0 = np.array([0.1, -0.1, 0.0, 0.0])
    *_rest, jth = _jax_solve(jev, frame, jspec, jnp.asarray(x0))
    _flow, aux = tgml.estimate_frame_gml(tev, frame, None, tspec, x0=x0,
                                         device=CPU)
    assert aux["theta_history"].shape == (3, 4)
    np.testing.assert_allclose(np_of(aux["theta_history"]), np_of(jth),
                               rtol=0, atol=1e-12)


def _jax_draws(sampler, n, dim, key=0):
    k1, _k2 = jax.random.split(jax.random.PRNGKey(key))
    return {"uniform": np.asarray(jax.random.uniform(
        k1, (n, dim), jnp.float32, jnp.full(dim, -3.0, jnp.float32),
        jnp.full(dim, 3.0, jnp.float32)))}


@pytest.mark.parametrize("sampler", ["grid", "random"])
def test_samplers_match_jax(sampler):
    """Grid: 81 trials on the 4-parameter model = 3 points an axis, exact
    in float32; random: the JAX package's 64 draws."""
    jev, tev, frame = _scene()
    n = 81 if sampler == "grid" else 64
    jspec, tspec = _spec_pair("plain_warp", sampler, n)
    jflow, jhist, jtheta, _ = _jax_solve(jev, frame, jspec)
    draws = _jax_draws(sampler, n, 4) if sampler == "random" else None
    tflow, aux = tgml.estimate_frame_gml(tev, frame, None, tspec,
                                         draws=draws, device=CPU)
    assert aux["theta"].dtype == torch.float32
    assert np.array_equal(np_of(aux["theta"]), np_of(jtheta))
    np.testing.assert_allclose(np_of(aux["history"]), np_of(jhist),
                               rtol=1e-5, atol=0)
    assert np.array_equal(np_of(tflow), np_of(jflow))


def test_host_tpe_study_matches_jax(monkeypatch):
    """One seed, 30 trials: the proposals depend on the losses only through
    their order, so the parameters agree bit for bit; one host read a
    trial."""
    jev, tev, frame = _scene()
    jspec, tspec = _spec_pair("plain_warp", "TPE", 30)
    jflow, jaux = jgml.make_host_tpe_solver(jspec)(jev, jnp.asarray(frame),
                                                   5)
    reads = []
    obj_for = tgml.make_host_objective(tspec, CPU)

    def counting(spec, device=None):
        def factory(ev, fr):
            objective = obj_for(ev, fr)
            return lambda x: reads.append(1) or objective(x)
        return factory

    monkeypatch.setattr(tgml, "make_host_objective", counting)
    tflow, aux = tgml.make_host_tpe_solver(tspec, CPU)(tev, frame, 5)
    assert len(reads) == 30
    assert np.array_equal(np_of(aux["theta"]), np_of(jaux["theta"]))
    np.testing.assert_allclose(np_of(aux["history"]), np_of(jaux["history"]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_of(tflow), np_of(jflow), rtol=0,
                               atol=1e-12)


def test_initialize_theta_and_the_sampler_box_check():
    g = torch.Generator(CPU).manual_seed(0)
    _j, tspec = _spec_pair("poisson_warp", "Adam", 1)
    theta = tgml.initialize_theta(g, tspec, CPU)
    assert theta.shape == (3,) and -1 <= float(theta[0]) < 1
    assert float(theta[1]) == float(theta[2]) == 0.0
    with pytest.raises(ValueError, match="Generator"):
        tgml.initialize_theta(None, tspec, CPU)
    _j, aspec = _spec_pair("angle_warp", "Adam", 1)
    assert np.array_equal(np_of(tgml.initialize_theta(None, aspec, CPU)),
                          [np.pi, 0.0, 0.0])
    _j, pspec = _spec_pair("plain_warp", "Adam", 1)
    assert not tgml.initialize_theta(None, pspec, CPU).any()
    for spec_cls, gen in zip((jgml.GmlSpec, tgml.GmlSpec),
                             _gens("plain_warp")):
        with pytest.raises(ValueError, match="4 parameters"):
            spec_cls(gen=gen, roi=ROI, method="random",
                     param_bounds=((-1.0, 1.0),) * 2)


def test_gml_evolution_video_matches_jax(tmp_path, monkeypatch):
    """``record_evolution: 4`` with a visualizer: the loss curve and the
    per-call evolution frames and videos, against the JAX facade's, from
    one injected ``x0``."""
    import cv2

    import event_based_bos_tpu.solver.facades as jfacades
    import event_based_bos_tpu.utils.config as jconfig
    import event_based_bos_tpu.visualizer as jviz
    import event_based_bos_tpu_torch.solver.facades as tfacades
    import event_based_bos_tpu_torch.visualizer as tviz
    from event_based_bos_tpu_torch import data as tdata
    from event_based_bos_tpu_torch.utils.config import propagate_config
    from torch_parity import inject_init, small_config

    def config(prop):
        cfg = small_config()
        cfg["solver"].update(method="generative_max_likelihood",
                             record_evolution=4)
        cfg["solver"]["optimizer"]["n_iter"] = 8
        prop(cfg)
        return cfg

    cfg = config(propagate_config)
    jcfg = config(jconfig.propagate_config)
    x0 = np.array([0.3, -0.2, 0.05])
    inject_init(monkeypatch, tfacades, x0, "gml")
    inject_init(monkeypatch, jfacades, x0, "gml")
    loader = tdata.collections["SYNTHETIC"](config=cfg["data"])
    loader.set_sequence(cfg["data"]["sequence"])
    im1, t1 = loader.load_image(1)
    _im2, t2 = loader.load_image(2)
    ev = loader.load_event(loader.time_to_index(t1), loader.time_to_index(t2))
    d = cfg["data"]
    args = ((d["height"], d["width"]), (d["crop_height"], d["crop_width"]))
    out = {}
    for tag, facades, c, kw, vcls, vkw in (
            ("torch", tfacades, cfg, {"device": CPU}, tviz.Visualizer,
             {"device": CPU}),
            ("jax", jfacades, jcfg, {}, jviz.Visualizer, {})):
        viz = vcls(args[0], save=True, save_dir=str(tmp_path / tag), **vkw)
        solv = facades.collections["generative_max_likelihood"](
            *args, solver_config=dict(c["solver"]), visualize_module=viz,
            **kw)
        filtered, _ = solv.preprocess(ev)
        out[tag] = solv.estimate(filtered, frame=im1)
        viz.flush()
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=1e-10)
    files = {tag: sorted(str(p.relative_to(tmp_path / tag))
                         for p in (tmp_path / tag).rglob("*") if p.is_file())
             for tag in out}
    assert files["torch"] == files["jax"]
    assert os.path.join("0", "opt_prediction0.png") in files["torch"]
    for name in files["torch"]:
        if not name.endswith(".png"):
            continue
        a, b = (cv2.imread(str(tmp_path / t / name), cv2.IMREAD_UNCHANGED)
                for t in ("torch", "jax"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
