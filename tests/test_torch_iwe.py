"""Parity of the port's blur and event votes with the JAX package.

The JAX Pallas vote runs in interpreter mode, as in
``tests/test_pallas_kernel.py``.  On these CPU tensors the port's
``iwe_cuda`` wrappers run the kernel's plain version (the CUDA kernel
itself is held against it on the card by ``chip_smoke.py``).

Tolerances: integer sensor coordinates give hat weights of exactly 0 or 1
and ±1 sums that are exact in f32 in any order, so those votes must be
bit-equal; fractional coordinates agree to f32 summation order and the
scatter's ``floor(x + 1e-6)`` nudge (≤ 1e-5 abs).  Blurs are the same
numpy operator applied by matmul (≤ 1e-6 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.ops.iwe as jiwe
import event_based_bos_tpu.ops.iwe_pallas as ipk
import event_based_bos_tpu_torch.ops.iwe as tiwe
import event_based_bos_tpu_torch.ops.iwe_cuda as tcuda
from event_based_bos_tpu_torch import kernels
from torch_parity import CPU, both_events, np_of, rand_event_fields, rel_err

H, W = 24, 40


@pytest.fixture(autouse=True)
def vote_interpret_mode():
    old = ipk.INTERPRET
    ipk.INTERPRET = True
    yield
    ipk.INTERPRET = old


@pytest.mark.parametrize("sigma", [2.0, 10.0])
@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gaussian_blur(sigma, mode, dtype):
    img = np.random.default_rng(0).normal(size=(2, 48, 64)).astype(dtype)
    want = jiwe.gaussian_blur(jnp.asarray(img), sigma, mode=mode)
    got = tiwe.gaussian_blur(torch.as_tensor(img), sigma, mode=mode)
    assert got.dtype == getattr(torch, dtype)
    assert rel_err(got, want) <= 1e-6
    ops = tiwe.blur_operators((48, 64), sigma, mode=mode,
                              dtype=getattr(torch, dtype), device=CPU)
    assert torch.equal(tiwe.gaussian_blur(torch.as_tensor(img), sigma,
                                          mode=mode, operators=ops), got)


def test_gaussian_kernel1d():
    for sigma, ksize in ((2.0, None), (1.0, 3), (10.0, None)):
        want = jiwe.gaussian_kernel1d(sigma, ksize)
        got = tiwe.gaussian_kernel1d(sigma, ksize, device=CPU)
        np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-6)


def _signs(jev):
    return np.where(np.asarray(jev.p) > 0, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("fractional", [False, True])
def test_bilinear_vote_scatter(fractional):
    rng = np.random.default_rng(1)
    jev, tev = both_events(rand_event_fields(700, H, W, rng, fractional))
    sign = _signs(jev)
    want = jiwe.bilinear_vote(jev, (H, W), weight=jnp.asarray(sign))
    got = tiwe.bilinear_vote(tev, (H, W), weight=torch.as_tensor(sign))
    if fractional:
        np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5)
    else:
        assert np.array_equal(np_of(got), np_of(want))


def test_bilinear_vote_padding_weights_and_polarity_iwe():
    rng = np.random.default_rng(2)
    jev, tev = both_events(rand_event_fields(400, H, W, rng, True))
    wgt = rng.uniform(0.2, 2.0, 400).astype(np.float32)
    want = jiwe.bilinear_vote(jev, (H, W), jnp.asarray(wgt), (3, 5))
    got = tiwe.bilinear_vote(tev, (H, W), torch.as_tensor(wgt), (3, 5))
    assert got.shape == (H + 6, W + 10)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5)
    want = jiwe.create_polarity_iwe(jev, (H, W))
    got = tiwe.create_polarity_iwe(tev, (H, W))
    assert got.shape == (2, H, W)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5)


def test_bilinear_vote_far_out_of_frame_with_padding():
    """Corners beyond the padding are dropped, not clamped into it."""
    rng = np.random.default_rng(9)
    jev, tev = both_events(rand_event_fields(600, H, W, rng, True, spread=8))
    want = jiwe.bilinear_vote(jev, (H, W), 1.0, (3, 5))
    got = tiwe.bilinear_vote(tev, (H, W), 1.0, (3, 5))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5)
    np.testing.assert_allclose(
        np_of(tcuda.bilinear_vote_cuda(tev, (H, W), 1.0, (3, 5))),
        np_of(want), atol=1e-5)


def test_bilinear_vote_gradient_flows_to_weights():
    rng = np.random.default_rng(3)
    _, tev = both_events(rand_event_fields(50, H, W, rng, True))
    wgt = torch.ones(50, requires_grad=True)
    tiwe.bilinear_vote(tev, (H, W), wgt).sum().backward()
    assert torch.isfinite(wgt.grad).all() and wgt.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# The kernel's wrappers (plain version on CPU) vs the Pallas vote and the
# XLA scatter
# ---------------------------------------------------------------------------

def _scatter_signed(jev, size, padding=(0, 0)):
    return jiwe.bilinear_vote(jev, size, weight=jnp.asarray(_signs(jev)),
                              padding=padding)


@pytest.mark.parametrize("masked", [False, True])
def test_signed_vote_integer_coords_bitexact(masked):
    rng = np.random.default_rng(4)
    keep = (rng.integers(0, 2, 1024) > 0) if masked else None
    jev, tev = both_events(rand_event_fields(1000, H, W, rng), keep=keep,
                           capacity=1024)
    got = np_of(tcuda.signed_vote_cuda(tev, (H, W)))
    assert np.array_equal(got, np_of(ipk.signed_vote_pallas(jev, (H, W),
                                                            chunk=256)))
    assert np.array_equal(got, np_of(_scatter_signed(jev, (H, W))))


@pytest.mark.parametrize("masked", [False, True])
def test_unsigned_vote_integer_coords_bitexact(masked):
    rng = np.random.default_rng(5)
    keep = (rng.integers(0, 2, 1024) > 0) if masked else None
    jev, tev = both_events(rand_event_fields(1000, H, W, rng), keep=keep,
                           capacity=1024)
    got = np_of(tcuda.bilinear_vote_cuda(tev, (H, W)))
    assert np.array_equal(got, np_of(ipk.bilinear_vote_pallas(jev, (H, W),
                                                              chunk=256)))
    assert np.array_equal(got, np_of(jiwe.bilinear_vote(jev, (H, W))))


def test_signed_vote_fractional_and_out_of_frame():
    rng = np.random.default_rng(6)
    jev, tev = both_events(rand_event_fields(1000, H, W, rng, True))
    got = np_of(tcuda.signed_vote_cuda(tev, (H, W), padding=(3, 5)))
    want_p = np_of(ipk.signed_vote_pallas(jev, (H, W), padding=(3, 5),
                                          chunk=256))
    want_s = np_of(_scatter_signed(jev, (H, W), padding=(3, 5)))
    assert got.shape == (H + 6, W + 10)
    np.testing.assert_allclose(got, want_p, atol=1e-5)
    np.testing.assert_allclose(got, want_s, atol=1e-5)


def test_unsigned_vote_padding_and_weights():
    rng = np.random.default_rng(7)
    jev, tev = both_events(rand_event_fields(800, H, W, rng, True))
    wgt = rng.uniform(0.2, 2.0, 800).astype(np.float32)
    got = np_of(tcuda.bilinear_vote_cuda(tev, (H, W), torch.as_tensor(wgt),
                                         (3, 5)))
    want = np_of(ipk.bilinear_vote_pallas(jev, (H, W), jnp.asarray(wgt),
                                          (3, 5), chunk=256))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        got, np_of(jiwe.bilinear_vote(jev, (H, W), jnp.asarray(wgt), (3, 5))),
        atol=1e-5)


def test_polarity_iwe_cuda_vs_pallas():
    rng = np.random.default_rng(8)
    jev, tev = both_events(rand_event_fields(600, H, W, rng, True))
    got = np_of(tcuda.polarity_iwe_cuda(tev, (H, W)))
    want = np_of(ipk.polarity_iwe_pallas(jev, (H, W), chunk=256))
    assert got.shape == want.shape == (2, H, W)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_hat_vote_image_far_and_invalid_coords_dropped():
    x = torch.tensor([-2.0, -0.5, 1e9, -1e9, float(H), 3.0])
    y = torch.tensor([-2.0, 2.0, 3.0, 3.0, 3.0, float(W) - 0.5])
    v = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 2.0])
    img = tcuda.hat_vote_image(x, y, v, (H, W))
    # only the in-frame halves of the last two events remain
    assert float(img.sum()) == pytest.approx(0.5 + 1.0)
    assert float(img[0, 2]) == pytest.approx(0.5)
    assert float(img[3, W - 1]) == pytest.approx(1.0)


def test_hat_vote_image_rejects_bad_inputs_and_counts_nothing_on_cpu():
    kernels.reset_launches()
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        tcuda.hat_vote_image(x.double(), x, x, (H, W))
    with pytest.raises(ValueError):
        tcuda.hat_vote_image(torch.zeros(8, 2)[:, 0], x, x, (H, W))
    with pytest.raises(ValueError):
        tcuda.hat_vote_image(x, torch.zeros(7), x, (H, W))
    tcuda.hat_vote_image(x, x, x, (H, W))
    assert kernels.launches["hat_vote_image"] == 0
