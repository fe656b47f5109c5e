"""Parity of the port's per-event warps (``ops/warp.py``) with JAX.

Float64 events (the conftest enables x64), so the comparisons are of the
formulas: ≤ 1e-12 abs in coordinates and flow gradients.  The dense-flow
gather truncates the coordinate and clips it to the frame, so events
outside the frame read the edge pixel in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.ops.events as jevents
import event_based_bos_tpu.ops.warp as jwarp
import event_based_bos_tpu_torch.ops.events as tevents
import event_based_bos_tpu_torch.ops.warp as twarp
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.types as ttypes
from torch_parity import CPU, np_of

H, W = 12, 18


def _events(n=300, seed=0, keep_frac=0.8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, H + 1, n)
    y = rng.uniform(-2, W + 1, n)
    t = rng.uniform(0.2, 1.7, n)
    p = rng.integers(0, 2, n) * 2 - 1.0
    keep = rng.uniform(size=n) < keep_frac
    jev = jtypes.events_from_arrays(x, y, t, p, dtype=jnp.float64
                                    ).mask_where(keep)
    tev = ttypes.events_from_arrays(x, y, t, p, dtype=torch.float64,
                                    device=CPU).mask_where(
        torch.as_tensor(keep))
    return jev, tev


def test_masked_min_max():
    jev, tev = _events()
    for a, b in zip(tevents._masked_min_max(tev.t, tev.valid),
                    jevents._masked_min_max(jev.t, jev.valid)):
        assert float(a) == float(b)
    none = torch.zeros(4, dtype=torch.bool)
    lo, hi = tevents._masked_min_max(torch.ones(4), none)
    assert float(lo) == np.inf and float(hi) == -np.inf


@pytest.mark.parametrize("direction", ["first", "middle", "last", "before",
                                       "after", 0.25, 1.5])
def test_calculate_reftime(direction):
    jev, tev = _events()
    want = jwarp.calculate_reftime(jev, direction)
    got = twarp.calculate_reftime(tev, direction)
    assert float(got) == float(want)


def test_calculate_reftime_random_and_unknown():
    _jev, tev = _events()
    with pytest.raises(ValueError, match="Generator"):
        twarp.calculate_reftime(tev, "random")
    with pytest.raises(ValueError, match="direction"):
        twarp.calculate_reftime(tev, "sideways")
    r = twarp.calculate_reftime(tev, "random",
                                torch.Generator().manual_seed(0))
    live = tev.t[tev.valid]
    assert float(live.min()) <= float(r) <= float(live.max())


@pytest.mark.parametrize("normalize_t", [False, True])
@pytest.mark.parametrize("period", [None, 0.7])
def test_calculate_dt(normalize_t, period):
    jev, tev = _events(seed=1)
    ref_j = jwarp.calculate_reftime(jev, "middle")
    ref_t = twarp.calculate_reftime(tev, "middle")
    want = jwarp.calculate_dt(jev, ref_j, normalize_t, period)
    got = twarp.calculate_dt(tev, ref_t, normalize_t, period)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-12)


@pytest.mark.parametrize("model", ["2d-translation", "rigid-optical-flow",
                                   "dense-flow"])
@pytest.mark.parametrize("normalize_t", [False, True])
def test_warp_event_and_gradient(model, normalize_t):
    jev, tev = _events(seed=2)
    rng = np.random.default_rng(3)
    motion = (rng.uniform(-3, 3, (2, H, W)) if model == "dense-flow"
              else np.array([1.7, -2.3]))
    w = rng.uniform(-1, 1, (2, jev.capacity))

    def jloss(m):
        out = jwarp.warp_event(jev, m, model, "middle", normalize_t)
        return jnp.sum(out.x * w[0] + out.y * w[1]), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(motion))
    tm = torch.as_tensor(motion).requires_grad_(True)
    tout = twarp.warp_event(tev, tm, model, "middle", normalize_t)
    (tout.x * torch.as_tensor(w[0]) + tout.y * torch.as_tensor(w[1])
     ).sum().backward()
    for a, b in ((tout.x, jout.x), (tout.y, jout.y), (tout.t, jout.t)):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-12)
    np.testing.assert_allclose(np_of(tm.grad), np_of(jg), atol=1e-12)


def test_warp_event_rejects_unknown_model():
    _jev, tev = _events()
    with pytest.raises(KeyError):
        twarp.warp_event(tev, torch.zeros(2), "affine")


@pytest.mark.parametrize("model", ["2d-translation", "dense-flow"])
@pytest.mark.parametrize("normalize_t", [False, True])
def test_get_flow_from_motion(model, normalize_t):
    rng = np.random.default_rng(4)
    motion = (rng.uniform(-3, 3, (2, 6, 9)).astype(np.float32)
              if model == "dense-flow"
              else np.array([0.75, -1.25], np.float32))
    want = jwarp.get_flow_from_motion(jnp.asarray(motion), model, (6, 9),
                                      normalize_t)
    got = twarp.get_flow_from_motion(torch.as_tensor(motion), model, (6, 9),
                                     normalize_t)
    assert got.shape == (2, 6, 9)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-6)


def test_motion_model_helpers():
    for model in ("dense-flow", "2d-translation", "rigid-optical-flow",
                  "scaler"):
        assert (twarp.motion_model_keys(model)
                == jwarp.motion_model_keys(model))
        assert (twarp.get_motion_vector_size(model)
                == jwarp.get_motion_vector_size(model))
    params = {"trans_x": 1.5, "trans_y": -2.0}
    m = twarp.motion_model_to_motion("2d-translation", params)
    np.testing.assert_array_equal(
        np_of(m), np_of(jwarp.motion_model_to_motion("2d-translation",
                                                     params)))
    back = twarp.motion_model_from_motion(m, "2d-translation")
    assert {k: float(v) for k, v in back.items()} == params
    with pytest.raises(KeyError):
        twarp.motion_model_keys("affine")
