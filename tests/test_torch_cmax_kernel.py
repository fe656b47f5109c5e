"""The plain versions of the port's CMax stencil kernels against the JAX
package's Pallas kernel (``cp.binned_warp_accumulate``, interpret mode).

The plain forward and backward repeat the CUDA kernels' formulas, so they
are held to the TPU kernel's own numbers: float32, forward within 1e-5
abs (the same products, summed in another order), VJP within 1e-6 abs.
At flow 0 every tap sits on a hat kink, where both give a VJP of exactly 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.ops.cmax_pallas as cp
from event_based_bos_tpu_torch.ops import cmax_cuda
from torch_parity import np_of


@pytest.fixture(autouse=True)
def interpret_mode():
    old = cp.INTERPRET
    cp.INTERPRET = True
    yield
    cp.INTERPRET = old


def _inputs(b, h, w, radius, flow_kind, seed):
    rng = np.random.default_rng(seed)
    hists = rng.uniform(0, 3, (b, h, w)).astype(np.float32)
    if flow_kind == "zero":
        flow = np.zeros((2, h, w), np.float32)
    elif flow_kind == "integer":
        flow = rng.integers(-2 * radius, 2 * radius + 1,
                            (2, h, w)).astype(np.float32)
    else:
        flow = rng.uniform(-2 * radius, 2 * radius, (2, h, w)).astype(
            np.float32)
    dts = ((np.arange(b) + 0.5) / b - 0.5).astype(np.float32)
    g = rng.uniform(-1, 1, (h, w)).astype(np.float32)
    return hists, flow, dts, g


@functools.partial(jax.jit, static_argnums=4)
def _jax_fwd_vjp_jit(hists, flow, dts, g, radius):
    out, vjp = jax.vjp(
        lambda fl: cp.binned_warp_accumulate(hists, fl, dts, radius, 8), flow)
    return out, vjp(g)[0]


def _jax_fwd_vjp(hists, flow, dts, g, radius):
    """The Pallas forward and VJP (compiled once per shape and radius)."""
    out, dflow = _jax_fwd_vjp_jit(*(jnp.asarray(a)
                                    for a in (hists, flow, dts, g)), radius)
    return np_of(out), np_of(dflow)


CASES = [(4, 24, 40, 1), (3, 24, 40, 2), (2, 16, 32, 3), (2, 19, 37, 1),
         (2, 19, 37, 2)]


@pytest.mark.parametrize("flow_kind", ["random", "integer", "zero"])
@pytest.mark.parametrize("b,h,w,radius", CASES)
def test_plain_versions_match_pallas(b, h, w, radius, flow_kind):
    hists, flow, dts, g = _inputs(b, h, w, radius, flow_kind, seed=radius)
    want_out, want_dflow = _jax_fwd_vjp(hists, flow, dts, g, radius)
    th, tf, td, tg = (torch.as_tensor(a) for a in (hists, flow, dts, g))
    got_out = cmax_cuda.binned_warp_accumulate_plain_fwd(th, tf, td, radius)
    du, dv = cmax_cuda.binned_warp_accumulate_plain_bwd(th, tf, td, tg,
                                                         radius)
    assert got_out.shape == (h, w) and got_out.dtype == torch.float32
    np.testing.assert_allclose(np_of(got_out), want_out, atol=1e-5)
    got_dflow = np.stack([np_of(du), np_of(dv)])
    np.testing.assert_allclose(got_dflow, want_dflow, atol=1e-6)
    if flow_kind == "zero":
        assert not got_dflow.any() and not want_dflow.any()


@pytest.mark.parametrize("radius", [1, 2])
def test_autograd_function_on_cpu_tensors(radius):
    """The autograd wrapper takes the plain versions on CPU tensors, casts
    float64 to float32 and hands the gradient back in the flow's dtype."""
    hists, flow, dts, g = _inputs(2, 19, 37, radius, "random", seed=7)
    want_out, want_dflow = _jax_fwd_vjp(hists, flow, dts, g, radius)
    tf = torch.as_tensor(flow, dtype=torch.float64).requires_grad_(True)
    out = cmax_cuda.binned_warp_accumulate(
        torch.as_tensor(hists, dtype=torch.float64), tf,
        torch.as_tensor(dts), radius)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(np_of(out), want_out, atol=1e-5)
    (out * torch.as_tensor(g)).sum().backward()
    assert tf.grad.dtype == torch.float64
    np.testing.assert_allclose(np_of(tf.grad), want_dflow, atol=1e-6)


def test_wrapper_rejects_bad_arguments():
    h = torch.zeros((2, 8, 8))
    f = torch.zeros((2, 8, 8))
    d = torch.zeros((2,))
    for radius in (0, 5, 2.0):
        with pytest.raises(ValueError, match="radius"):
            cmax_cuda.binned_warp_accumulate(h, f, d, radius)
    with pytest.raises(ValueError, match="flow"):
        cmax_cuda.binned_warp_accumulate(h, f[:, :4], d, 2)
    with pytest.raises(ValueError, match="dts"):
        cmax_cuda.binned_warp_accumulate(h, f, d[:1], 2)
