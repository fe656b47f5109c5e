"""The plain versions of the port's CMax stencil kernels against the JAX
package's Pallas kernel (``cp.binned_warp_accumulate``, interpret mode).

The plain forward and backward are the full (2R+1)² hat sum, so they are
held to the TPU kernel's own numbers: float32, forward within 1e-5 abs (the
same products, summed in another order), VJP within 1e-6 abs, on flows
inside R, beyond it (shifts up to 2R) and on the kinks (every shift an
integer or a half-integer). At flow 0 every tap sits on a hat kink, where
both give a VJP of exactly 0.

The CUDA kernels evaluate only the ≤ 2×2 taps per pixel and bin that can
carry weight (``csrc/cmax_stencil.cu``, ``tap_pair``). That selection rule
is written out here in torch and held to the plain sum: per axis, tap by
tap and bit for bit, and as a whole, forward and VJP.
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
    """Histograms, flow, bin offsets and cotangent. The first three flow
    kinds take the cell's kind of dts (|dt| < 0.5, shifts within 0.75R);
    the others take dts of ±1 and ±0.5: ``beyond_r`` shifts up to 2R,
    ``integer_shift`` / ``half_shift`` every shift an integer / a
    half-integer (up to 2R)."""
    rng = np.random.default_rng(seed)
    hists = rng.uniform(0, 3, (b, h, w)).astype(np.float32)
    dts = ((np.arange(b) + 0.5) / b - 0.5).astype(np.float32)
    if flow_kind == "beyond_r":
        dts = np.resize(np.float32([1.0, -0.5, 0.5, -1.0]), b)
        flow = rng.uniform(-2 * radius, 2 * radius, (2, h, w)).astype(
            np.float32)
    elif flow_kind in ("integer_shift", "half_shift"):
        dts = np.resize(np.float32([1.0, -1.0]), b)
        if flow_kind == "integer_shift":
            flow = rng.integers(-2 * radius, 2 * radius + 1, (2, h, w))
        else:
            flow = rng.integers(-2 * radius, 2 * radius, (2, h, w)) + 0.5
        flow = flow.astype(np.float32)
    elif flow_kind == "zero":
        flow = np.zeros((2, h, w), np.float32)
    elif flow_kind == "integer":
        flow = rng.integers(-2 * radius, 2 * radius + 1,
                            (2, h, w)).astype(np.float32)
    else:
        flow = rng.uniform(-2 * radius, 2 * radius, (2, h, w)).astype(
            np.float32)
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


@pytest.mark.parametrize("flow_kind", ["random", "integer", "zero",
                                       "beyond_r", "integer_shift",
                                       "half_shift"])
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


def _pair(s, radius):
    """The CUDA kernels' taps of one axis for the shift ``s``
    (``csrc/cmax_stencil.cu``, ``tap_pair``): offsets p and p + 1 with
    p = clamp(floor(−s), −R, R − 1), and a_k = s + (p + k), rounded in the
    input's precision as the full tap loop rounds s + o."""
    p = torch.clamp(torch.floor(-s), -radius, radius - 1)
    return p, (s + p, s + (p + 1))


def _two_by_two(hists, flow, dts, g, radius):
    """Forward and VJP through the 2×2 selection rule, in the kernels'
    order: bins outer, then the row offset, then the column offset."""
    b, h, w = hists.shape
    hp = torch.nn.functional.pad(hists, (radius,) * 4)  # zero outside
    rows = torch.arange(h)[:, None] + radius
    cols = torch.arange(w)[None, :] + radius
    out, du, dv = (torch.zeros((h, w)) for _ in range(3))
    for k in range(b):
        nd = -dts[k]
        pr, au = _pair(nd * flow[0], radius)
        pc, av = _pair(nd * flow[1], radius)
        for i in (0, 1):
            for j in (0, 1):
                hv = hp[k, rows + pr.long() + i, cols + pc.long() + j]
                wr, wc = cmax_cuda._hat(au[i]), cmax_cuda._hat(av[j])
                out = out + wr * wc * hv
                gh = g * hv
                du = du + nd * cmax_cuda._dhat(au[i]) * wc * gh
                dv = dv + nd * wr * cmax_cuda._dhat(av[j]) * gh
    return out, du, dv


def _shifts(kind, radius, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        s = rng.uniform(-radius, radius, 4096)
    elif kind == "integer":
        s = rng.integers(-2 * radius - 1, 2 * radius + 2, 4096)
    elif kind == "half_integer":
        s = rng.integers(-2 * radius - 1, 2 * radius + 1, 4096) + 0.5
    elif kind == "beyond_r":
        s = rng.uniform(-2 * radius - 1.5, 2 * radius + 1.5, 4096)
    else:  # a float32 step or a few away from every integer, and tiny
        k = np.arange(-2 * radius - 1, 2 * radius + 2, dtype=np.float32)
        near = [np.nextafter(k, k + d) for d in (-1, 1)]
        near += [np.nextafter(a, a + d) for a, d in zip(near, (-1, 1))]
        s = np.concatenate(near + [k, np.float32([1e-30, -1e-30, 1e-45,
                                                   -1e-45, -0.0])])
    return torch.as_tensor(np.asarray(s, np.float32))


@pytest.mark.parametrize("kind", ["random", "integer", "half_integer",
                                  "beyond_r", "near_kinks"])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_two_by_two_rule_keeps_every_weighted_tap(radius, kind):
    """For each offset o in [−R, R], hat(s + o) and dhat(s + o) of the full
    tap loop equal what the 2×2 rule gives o (its weight if o is p or p + 1,
    else 0), bit for bit up to the sign of a zero."""
    s = _shifts(kind, radius, seed=radius)
    p, (a0, a1) = _pair(s, radius)
    assert (p >= -radius).all() and (p + 1 <= radius).all()
    for o in range(-radius, radius + 1):
        a = s + o
        for f in (cmax_cuda._hat, cmax_cuda._dhat):
            got = torch.where(p == o, f(a0), torch.where(p + 1 == o, f(a1),
                                                         0.0))
            assert torch.equal(got, f(a)), (o, f.__name__)


@pytest.mark.parametrize("flow_kind", ["random", "beyond_r", "integer_shift",
                                       "half_shift"])
@pytest.mark.parametrize("radius", [1, 2])
def test_two_by_two_rule_matches_plain_sum(radius, flow_kind):
    hists, flow, dts, g = (torch.as_tensor(a) for a in _inputs(
        3, 19, 37, radius, flow_kind, seed=11))
    out, du, dv = _two_by_two(hists, flow, dts, g, radius)
    want_out = cmax_cuda.binned_warp_accumulate_plain_fwd(hists, flow, dts,
                                                          radius)
    want_du, want_dv = cmax_cuda.binned_warp_accumulate_plain_bwd(
        hists, flow, dts, g, radius)
    np.testing.assert_allclose(np_of(out), np_of(want_out), atol=1e-5)
    np.testing.assert_allclose(np_of(torch.stack([du, dv])),
                               np_of(torch.stack([want_du, want_dv])),
                               atol=1e-6)


def test_pitched_histograms_layout():
    """The kernels read histogram rows that start on 16 bytes: a contiguous
    float32 array of a width that is a multiple of 4 passes as it is; any
    other is copied once into a zero-padded buffer and handed back as a
    view with the same values, cast to float32."""
    even = torch.rand(3, 19, 44)
    assert cmax_cuda.pitched_histograms(even).data_ptr() == even.data_ptr()
    for hists in (torch.rand(3, 19, 37),
                  torch.rand(3, 19, 64, dtype=torch.float64)[:, :, 2:39]):
        got = cmax_cuda.pitched_histograms(hists)
        assert got.dtype == torch.float32 and got.shape == hists.shape
        assert torch.equal(got, hists.to(torch.float32))
        assert got.stride() == (19 * 40, 40, 1) and got.data_ptr() % 16 == 0
