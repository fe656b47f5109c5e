"""Parity of the port's Sobel, central differences, resize, pattern-shift
warp and global shifts with JAX.

Tolerances: float32 inputs, ≤ 1e-6 relative to the output's scale for
the Sobel and resize (same taps and operators, different summation
order), ≤ 1e-5 abs for the warps and their flow gradients; float64 for
the central differences and the global shifts (≤ 1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.ops.gradients as jgrad
import event_based_bos_tpu.ops.image_warp as jwarp
import event_based_bos_tpu_torch.ops.gradients as tgrad
import event_based_bos_tpu_torch.ops.image_warp as twarp
from torch_parity import CPU, np_of, rel_err


def _img(shape, seed=0, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("pad_mode", ["edge", "reflect"])
def test_sobel_xy(ksize, pad_mode):
    img = _img((2, 20, 30))
    want = jgrad.sobel_xy(jnp.asarray(img), ksize, pad_mode)
    got = tgrad.sobel_xy(torch.as_tensor(img), ksize, pad_mode)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert rel_err(a, b) <= 1e-6


def test_sobel_kernels():
    for ksize in (3, 5):
        for a, b in zip(tgrad.sobel_kernels(ksize, device=CPU),
                        jgrad.sobel_kernels(ksize)):
            assert np.array_equal(np_of(a), np_of(b))
    with pytest.raises(ValueError):
        tgrad.sobel_kernels(7, device=CPU)


@pytest.mark.parametrize("use_log", [False, True])
def test_frame_gradients(use_log):
    img = _img((24, 40), seed=1)
    want = jgrad.frame_gradients(jnp.asarray(img), use_log_intensity=use_log)
    got = tgrad.frame_gradients(torch.as_tensor(img), use_log_intensity=use_log)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= 1e-6


@pytest.mark.parametrize("shape", [(1, 2), (3, 5), (12, 20)])
def test_poisson_to_flow(shape):
    pot = _img(shape, seed=2, lo=-1.0, hi=1.0)
    want = jgrad.poisson_to_flow(jnp.asarray(pot))
    got = tgrad.poisson_to_flow(torch.as_tensor(pot))
    assert got.shape == (2,) + shape
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-6)


@pytest.mark.parametrize("in_shape,out_shape", [
    ((3, 5), (6, 10)), ((6, 10), (12, 20)), ((12, 20), (6, 10)),
    ((1, 2), (2, 3)),
])
def test_resize_bilinear(in_shape, out_shape):
    img = _img((4,) + in_shape, seed=3, lo=-1.0, hi=1.0)
    want = jwarp.resize_bilinear(jnp.asarray(img), out_shape)
    got = twarp.resize_bilinear(torch.as_tensor(img), out_shape)
    assert got.shape == (4,) + out_shape
    assert rel_err(got, want) <= 1e-6
    assert np.array_equal(twarp._resize_matrix_np(in_shape[0], out_shape[0]),
                          jwarp._resize_matrix_np(in_shape[0], out_shape[0]))


def _flow(shape, bound, seed):
    return np.random.default_rng(seed).uniform(-bound, bound,
                                               (2,) + shape).astype(np.float32)


@pytest.mark.parametrize("radius,bound", [(1, 0.4), (1, 1.9), (2, 1.9)])
def test_warp_image_stencil_and_flow_gradient(radius, bound):
    img = _img((2, 20, 30), seed=4, lo=-1.0, hi=1.0)
    flow = _flow((20, 30), bound, seed=5)
    g = _img((2, 20, 30), seed=6, lo=-1.0, hi=1.0)
    want = jwarp.warp_image_stencil(jnp.asarray(img), jnp.asarray(flow),
                                    radius)
    got = twarp.warp_image_stencil(torch.as_tensor(img),
                                   torch.as_tensor(flow), radius)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5)

    jg = jax.grad(lambda f: jnp.sum(jwarp.warp_image_stencil(
        jnp.asarray(img), f, radius) * g))(jnp.asarray(flow))
    tf = torch.as_tensor(flow).requires_grad_(True)
    (twarp.warp_image_stencil(torch.as_tensor(img), tf, radius)
     * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(np_of(tf.grad), np_of(jg), atol=1e-5)


def test_warp_image_stencil_global_shift():
    img = _img((20, 30), seed=7, lo=-1.0, hi=1.0)
    shift = np.array([0.3, -0.7], np.float32)
    want = jwarp.warp_image_stencil(jnp.asarray(img), jnp.asarray(shift), 1)
    got = twarp.warp_image_stencil(torch.as_tensor(img),
                                   torch.as_tensor(shift), 1)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5)


def test_warp_image_forward_radius0_path():
    img = _img((20, 30), seed=8, lo=-1.0, hi=1.0)
    flow = _flow((20, 30), 2.5, seed=9)
    want = jwarp.warp_image_forward(jnp.asarray(img), jnp.asarray(flow))
    got = twarp.warp_image_forward(torch.as_tensor(img), torch.as_tensor(flow))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5)
    rows = np.array([[-0.5, 3.2], [19.5, 7.0]], np.float32)
    cols = np.array([[2.0, 29.5], [4.4, -3.0]], np.float32)
    want = jwarp.sample_bilinear(jnp.asarray(img), jnp.asarray(rows),
                                 jnp.asarray(cols))
    got = twarp.sample_bilinear(torch.as_tensor(img), torch.as_tensor(rows),
                                torch.as_tensor(cols))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, -1, -2])
def test_central_gradient(axis):
    img = np.random.default_rng(10).normal(size=(5, 7, 9))
    want = jgrad.central_gradient(jnp.asarray(img), axis)
    got = tgrad.central_gradient(torch.as_tensor(img), axis)
    assert got.shape == img.shape
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-12)
    np.testing.assert_allclose(np_of(got), np.gradient(img, axis=axis),
                               atol=1e-12)


@pytest.mark.parametrize("shift", [[1.3, -2.7], [0.0, 0.0], [-7.5, 11.2],
                                   [2.0, -1.0]])
def test_shift_image_matrix_and_warp_image_shift(shift):
    """Values and the shift's gradient, including integer shifts (hat
    kinks) and shifts beyond one pixel."""
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 1, (20, 26))
    g = rng.uniform(-1, 1, (20, 26))
    for jfn, tfn in ((jwarp.shift_image_matrix, twarp.shift_image_matrix),
                     (jwarp.warp_image_shift, twarp.warp_image_shift)):
        jv, jg = jax.value_and_grad(
            lambda s: jnp.sum(jfn(jnp.asarray(img), s) * g))(
            jnp.asarray(shift))
        ts = torch.as_tensor(shift, dtype=torch.float64).requires_grad_(True)
        tv = (tfn(torch.as_tensor(img), ts) * torch.as_tensor(g)).sum()
        tv.backward()
        assert abs(float(tv.detach()) - float(jv)) <= 1e-12 * max(
            1.0, abs(float(jv)))
        np.testing.assert_allclose(np_of(ts.grad), np_of(jg), atol=1e-12)
    a = twarp.shift_image_matrix(torch.as_tensor(img), torch.as_tensor(shift))
    b = twarp.warp_image_shift(torch.as_tensor(img), torch.as_tensor(shift))
    np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-12)


def test_shift_image_matrix_one_shift_per_image():
    """A ``[B, 2]`` shift moves each of ``B`` images by its own shift, as
    the binned translation objective uses it."""
    rng = np.random.default_rng(12)
    imgs = rng.uniform(0, 1, (3, 10, 14))
    shifts = rng.uniform(-3, 3, (3, 2))
    got = twarp.shift_image_matrix(torch.as_tensor(imgs),
                                   torch.as_tensor(shifts))
    for i in range(3):
        want = jwarp.shift_image_matrix(jnp.asarray(imgs[i]),
                                        jnp.asarray(shifts[i]))
        np.testing.assert_allclose(np_of(got[i]), np_of(want), atol=1e-12)
