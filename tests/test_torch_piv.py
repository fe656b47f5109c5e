"""Parity of the port's PIV (``piv.py``) with the JAX package's.

The frames are textured particle images made with numpy from a seed (the
recipe of ``tests/test_ops_flow.py::TestPIVAccuracy``: flat windows would
let FFT rounding pick another of several equal correlation peaks).
Tolerances: ``smoothn`` within 1e-12 of ``scipy.fft.dctn``'s formula and
of JAX's in float64; the validation masks bit for bit and the local-mean
replacement within 1e-12; ``piv_multipass`` in float64 within 1e-9 px of
the JAX package's passes run in float64 (its ``piv_multipass`` casts the
frames to float32, so ``torch_parity.jax_piv_multipass64`` drives its
``_one_iteration`` as that function does, on float64 frames), and in float32 within 1e-4 px of JAX's
``piv_multipass`` itself (FFT and reduction rounding of two libraries).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

import event_based_bos_tpu.piv as jpiv
from event_based_bos_tpu.utils.config import PivSettings as JPivSettings
import event_based_bos_tpu_torch.piv as tpiv
from event_based_bos_tpu_torch.utils.config import (PivSettings,
                                                    load_config_openpiv)
from torch_parity import jax_piv_multipass64, np_of, torch_threads

SHAPE = (128, 160)
SHIFT = (2.3, -1.7)  # (row, col) px


@pytest.fixture(autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


def render_particles(pos, shape, sigma=1.2):
    img = np.zeros(shape)
    rr, cc = np.mgrid[0:shape[0], 0:shape[1]].astype(float)
    for r, c in pos:
        m = (np.abs(rr - r) < 5) & (np.abs(cc - c) < 5)
        img[m] += np.exp(-((rr[m] - r) ** 2 + (cc[m] - c) ** 2)
                         / (2 * sigma ** 2))
    return 255.0 * img / max(img.max(), 1e-9)


def particle_pair(shape=SHAPE, shift=SHIFT, n=900, seed=3):
    """Two particle images, the second's particles moved by ``shift``
    plus a gentle shear (so that validation and smoothing have work)."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(4, shape[0] - 4, n),
                    rng.uniform(4, shape[1] - 4, n)], 1)
    moved = pos + np.asarray(shift) + np.stack(
        [np.zeros(n), 0.01 * (pos[:, 0] - shape[0] / 2)], 1)
    return render_particles(pos, shape), render_particles(moved, shape)


def both_settings(**kw):
    return JPivSettings(**kw), PivSettings(**kw)


@pytest.mark.parametrize("shape", [(12, 16), (33, 20)])
def test_smoothn_matches_the_dct_formula_and_jax(shape):
    rng = np.random.default_rng(0)
    f = rng.normal(size=shape)
    s = 0.05
    n, m = shape
    lam = ((-2 + 2 * np.cos(np.pi * np.arange(n) / n))[:, None]
           + (-2 + 2 * np.cos(np.pi * np.arange(m) / m))[None, :])
    want = scipy.fft.idctn(scipy.fft.dctn(f, norm="ortho")
                           / (1 + s * lam ** 2), norm="ortho")
    got = np_of(tpiv.smoothn(torch.as_tensor(f), s))
    assert np.max(np.abs(got - want)) <= 1e-12
    assert np.max(np.abs(got - np.asarray(jpiv.smoothn(jnp.asarray(f), s)))
                  ) <= 1e-12
    c = np_of(tpiv.dct2_matrix(n, torch.float64, torch.device("cpu")))
    assert np.max(np.abs(c @ f - scipy.fft.dct(f, axis=0, norm="ortho"))
                  ) <= 1e-12


def test_validation_and_replacement_match_jax():
    rng = np.random.default_rng(1)
    u = rng.normal(0, 1, (14, 18))
    v = rng.normal(0, 1, (14, 18))
    u[3, 4], v[7, 7], u[0, 0] = 40.0, -30.0, 9.0   # box, std, median
    v[10:13, 10:13] = 8.0                          # a block: erosion
    s2n = rng.uniform(0.5, 3, u.shape)
    for validate in (False, True):
        js, ts = both_settings(sig2noise_validate=validate)
        jb = jpiv._validate(jnp.asarray(u), jnp.asarray(v), jnp.asarray(s2n),
                            js, False)
        tb = tpiv._validate(torch.as_tensor(u), torch.as_tensor(v),
                            torch.as_tensor(s2n), ts)
        assert np.array_equal(np_of(tb), np.asarray(jb)) and np_of(tb).any()
        for iters in (1, 2):
            ju = jpiv._replace_localmean(jnp.asarray(u), jnp.asarray(v), jb,
                                         iters, 1)
            tu = tpiv._replace_localmean(torch.as_tensor(u),
                                         torch.as_tensor(v), tb, iters, 1)
            for a, b in zip(tu, ju):
                assert np.max(np.abs(np_of(a) - np.asarray(b))) <= 1e-12


@pytest.mark.parametrize("kw", [
    {"windowsizes": (64, 32), "overlap": (32, 16)},
    {"windowsizes": (64, 32), "overlap": (32, 16),
     "deformation_method": "second image", "smoothn": False,
     "sig2noise_validate": True, "roi": (8, 120, 16, 144)},
    {"windowsizes": (32, 16, 8), "overlap": (16, 8, 4),
     "sig2noise_method": "peak2mean", "scaling_factor": 2.0, "dt": 0.5},
])
def test_piv_multipass_float64_matches_jax(kw):
    fa, fb = particle_pair()
    js, ts = both_settings(**kw)
    got = tpiv.piv_multipass(fa, fb, ts, device="cpu", dtype=torch.float64)
    assert got.dtype == np.float64 and got.shape == (2,) + SHAPE
    want = jax_piv_multipass64(fa, fb, js)
    assert np.max(np.abs(got - want)) <= 1e-9
    x0, _x1, _y0, y1 = ts.roi or (0, SHAPE[0], 0, SHAPE[1])
    assert not got[:, :x0].any() and not got[:, :, y1:].any()


def test_piv_multipass_float32_matches_jax_and_recovers_the_shift():
    fa, fb = particle_pair()
    js, ts = both_settings(windowsizes=(64, 32), overlap=(32, 16))
    got = tpiv.piv_multipass(fa, fb, ts, device="cpu")
    want = jpiv.piv_multipass(fa, fb, js)
    assert got.dtype == np.float32
    assert np.max(np.abs(got - want)) <= 1e-4
    rng = np.random.default_rng(9)
    pos = np.stack([rng.uniform(4, SHAPE[0] - 4, 900),
                    rng.uniform(4, SHAPE[1] - 4, 900)], 1)
    a = render_particles(pos, SHAPE)
    b = render_particles(pos + np.asarray(SHIFT), SHAPE)
    flow = tpiv.piv_multipass(a, b, ts, device="cpu")
    inner = (slice(32, 96), slice(32, 128))
    assert np.abs(flow[1][inner] - SHIFT[0]).mean() < 0.1
    assert np.abs(flow[0][inner] - SHIFT[1]).mean() < 0.1


def test_frames_smaller_than_every_window_raise():
    with pytest.raises(ValueError, match="smaller"):
        tpiv.piv_multipass(np.zeros((16, 16)), np.zeros((16, 16)),
                           PivSettings(windowsizes=(32,), overlap=(16,)),
                           device="cpu")


def test_load_config_openpiv_matches_jax():
    from event_based_bos_tpu.utils.config import (
        load_config_openpiv as jload)

    common = {"xmin": 0, "xmax": 720, "ymin": 320, "ymax": 960}
    for params in ({"windowsizes": [64, 32, 16, 8],
                    "overlap": [32, 16, 8, 4],
                    "deformation_method": "symmetric",
                    "MinMax_U_disp": [-20, 20], "MinMax_V_disp": [-20, 20]},
                   {"windowsizes": [32], "overlap": [16], "ROI": "full"}):
        got = dataclasses.asdict(load_config_openpiv(params, common, "."))
        assert got == dataclasses.asdict(jload(params, common, "."))
    assert dataclasses.asdict(PivSettings()) == dataclasses.asdict(
        JPivSettings())
