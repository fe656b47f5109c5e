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
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.ops.iwe as tiwe
import event_based_bos_tpu_torch.ops.iwe_cuda as tcuda
import event_based_bos_tpu_torch.types as ttypes
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


# ---------------------------------------------------------------------------
# The vote entry's keyword arguments (validity, sign, polarity planes,
# weights, offset, origin, pitch, planes, nudge): its plain version against
# the JAX package, and a mirror of the kernel's arithmetic against it
# ---------------------------------------------------------------------------

def _compare(got, want, exact, atol=1e-5):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    if exact:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("fractional", [False, True])
def test_hat_vote_plain_offset_and_weights_vs_pallas(fractional):
    """The padding as a float offset: the Pallas wrapper's ``x + ph``."""
    rng = np.random.default_rng(10)
    x, y, _t, _p = rand_event_fields(900, H, W, rng, fractional, spread=8)
    wgt = (rng.uniform(0.2, 2.0, 900) if fractional
           else rng.integers(0, 2, 900) * 2 - 1).astype(np.float32)
    ph, pw = 3, 5
    size = (H + 2 * ph, W + 2 * pw)
    want = ipk.hat_vote_image(jnp.asarray(x) + ph, jnp.asarray(y) + pw,
                              jnp.asarray(wgt), size, chunk=256)
    got = tcuda.hat_vote_plain(torch.as_tensor(x), torch.as_tensor(y),
                               torch.as_tensor(wgt), size, offset=(ph, pw))
    _compare(got, want, exact=not fractional)


@pytest.mark.parametrize("fractional", [False, True])
def test_hat_vote_plain_signed_and_polarity_planes_vs_pallas(fractional):
    """Validity and polarity read from the record: the signed vote and the
    polarity pair (weights, padding) of the Pallas wrappers."""
    rng = np.random.default_rng(11)
    keep = rng.integers(0, 2, 1024) > 0
    jev, tev = both_events(rand_event_fields(1000, H, W, rng, fractional,
                                             spread=6), keep=keep,
                           capacity=1024)
    wgt = rng.uniform(0.2, 2.0, 1024).astype(np.float32)
    pad = (3, 5)
    size = (H + 6, W + 10)
    got = tcuda.hat_vote_plain(tev.x, tev.y, None, size, valid=tev.valid,
                               sign=tev.p, offset=pad)
    _compare(got, ipk.signed_vote_pallas(jev, (H, W), padding=pad,
                                         chunk=256), exact=not fractional)
    got = tcuda.hat_vote_plain(tev.x, tev.y, torch.as_tensor(wgt), size,
                               valid=tev.valid, polarity_planes=tev.p,
                               offset=pad)
    want = ipk.polarity_iwe_pallas(jev, (H, W), jnp.asarray(wgt), pad,
                                   chunk=256)
    _compare(got, want, exact=False)
    scalar = tcuda.hat_vote_plain(tev.x, tev.y, None, size, valid=tev.valid,
                                  polarity_planes=tev.p, scale=0.5,
                                  offset=pad)
    _compare(scalar, ipk.polarity_iwe_pallas(jev, (H, W), 0.5, pad,
                                             chunk=256), exact=not fractional)


def _nudge_fields(dtype, rng, n=1200):
    """Integers, coordinates within 1e-6 below an integer (a few ulps in
    float32), fractional ones and some out of the frame."""
    ints_x = rng.integers(0, H, n).astype(dtype)
    ints_y = rng.integers(0, W, n).astype(dtype)
    if dtype == np.float32:
        ulps = rng.integers(1, 8, n)
        below_x = np.array([np.float32(a) - u * np.spacing(np.float32(a))
                            for a, u in zip(ints_x, ulps)], np.float32)
        below_y = np.array([np.float32(a) - u * np.spacing(np.float32(a))
                            for a, u in zip(ints_y, ulps)], np.float32)
    else:
        below_x = ints_x - rng.uniform(1e-8, 9e-7, n)
        below_y = ints_y - rng.uniform(1e-8, 9e-7, n)
    frac_x = rng.uniform(-2, H + 1, n).astype(dtype)
    frac_y = rng.uniform(-2, W + 1, n).astype(dtype)
    pick = rng.integers(0, 3, n)
    x = np.choose(pick, [ints_x, below_x, frac_x]).astype(dtype)
    y = np.choose(rng.integers(0, 3, n), [ints_y, below_y, frac_y])
    p = (rng.integers(0, 2, n) * 2 - 1).astype(dtype)
    t = np.sort(rng.uniform(0, 1, n)).astype(dtype)
    return x, y.astype(dtype), t, p


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("integer", [True, False])
def test_hat_vote_plain_nudge_vs_scatter(dtype, integer):
    """``nudge`` is the scatter's ``floor(x + 1e-6)``, and a negative origin
    its integer padding: the JAX package's ``ops/iwe.bilinear_vote``."""
    rng = np.random.default_rng(12)
    npd = getattr(np, dtype)
    if integer:
        fields = rand_event_fields(1000, H, W, rng)
        fields = tuple(a.astype(npd) for a in fields)
    else:
        fields = _nudge_fields(npd, rng)
    n = fields[0].shape[0]
    wgt = (np.ones(n) if integer else rng.uniform(0.2, 2.0, n)).astype(npd)
    jev = jtypes.events_from_arrays(*fields, dtype=getattr(jnp, dtype))
    tev = ttypes.events_from_arrays(*fields, dtype=getattr(torch, dtype),
                                    device=CPU)
    ph, pw = 2, 3
    want = jiwe.bilinear_vote(jev, (H, W), jnp.asarray(wgt), (ph, pw))
    got = tcuda.hat_vote_plain(tev.x, tev.y, torch.as_tensor(wgt),
                               (H + 2 * ph, W + 2 * pw), valid=tev.valid,
                               origin=(-ph, -pw), nudge=True)
    assert got.dtype == getattr(torch, dtype)
    if integer:
        _compare(got, want, exact=True)
    elif dtype == "float64":
        assert rel_err(got, want) <= 1e-6
    else:
        _compare(got, want, exact=False)


def _mirror(x, y, values, image_size, *, valid=None, sign=None,
            polarity_planes=None, scale=1.0, plane=None, planes=None,
            offset=(0.0, 0.0), origin=(0, 0), pitch=None, nudge=False):
    """``csrc/hat_vote.cu``'s thread body in numpy float32, event by event
    and branch for branch: the memset of ``[P, h, pitch]``, the event's
    value and plane from the record, the floor, the box test on it, the
    origin off the integer corner, and one add per nonzero in-box corner."""
    f32 = np.float32
    h, w = image_size
    pitch = w if pitch is None else pitch
    n_planes = 2 if polarity_planes is not None else planes or 1
    p_mode = 1 if sign is not None else 2 if polarity_planes is not None else 0
    p = sign if sign is not None else polarity_planes
    org_r, org_c = origin
    lo_r, hi_r = f32(org_r - 1), f32(org_r + h - 1)
    lo_c, hi_c = f32(org_c - 1), f32(org_c + w - 1)
    arr = {k: None if t is None else t.numpy() for k, t in dict(
        x=x, y=y, valid=valid, p=p, weight=values, plane=plane).items()}
    out = np.zeros((n_planes, h, pitch), f32)
    for i in range(arr["x"].shape[0]):
        if arr["valid"] is not None and not arr["valid"][i]:
            continue
        v, q = f32(scale), 0
        if p_mode == 1:
            if not f32(arr["p"][i]) > 0:
                v = -v
        elif p_mode == 2:
            pi = f32(arr["p"][i])
            if pi > 0:
                q = 0
            elif pi <= 0:
                q = 1
            else:
                continue
        if arr["weight"] is not None:
            v = f32(v * f32(arr["weight"][i]))
        if arr["plane"] is not None:
            q = int(arr["plane"][i])
        if v == 0 or q < 0 or q >= n_planes:
            continue
        xi = f32(f32(arr["x"][i]) + f32(offset[0]))
        yi = f32(f32(arr["y"][i]) + f32(offset[1]))
        fx = np.floor(f32(xi + f32(1e-6)) if nudge else xi)
        fy = np.floor(f32(yi + f32(1e-6)) if nudge else yi)
        if not (lo_r <= fx <= hi_r and lo_c <= fy <= hi_c):
            continue
        dx, dy = f32(xi - fx), f32(yi - fy)
        r0, c0 = int(fx) - org_r, int(fy) - org_c
        wr, wc = (f32(1 - dx), dx), (f32(1 - dy), dy)
        for u in (0, 1):
            for s_ in (0, 1):
                r, c = r0 + u, c0 + s_
                wgt = f32(wr[u] * wc[s_])
                if r < 0 or r >= h or c < 0 or c >= w or wgt == 0:
                    continue
                out[q, r, c] = f32(out[q, r, c] + f32(wgt * v))
    assert not out[..., w:].any(), "a pad column was written"
    out = out[..., :w]
    return out[0] if planes is None and n_planes == 1 else out


def _mirror_case(name, rng):
    """``(x, y, values, image_size, kwargs, exact)`` of one mirror case."""
    n = 3000
    if name == "719x1283, odd sizes":
        size = (719, 1283)
        x = rng.uniform(-3, size[0] + 2, n)
        y = rng.uniform(-3, size[1] + 2, n)
        return x, y, rng.uniform(0.2, 2.0, n), size, {}, False
    if name == "pitch wider than the width, planes":
        size = (40, 50)
        x = rng.integers(-1, size[0] + 1, n).astype(float)
        y = rng.integers(-1, size[1] + 1, n).astype(float)
        kw = dict(pitch=68, planes=3,
                  plane=torch.as_tensor(rng.integers(-1, 4, n)))
        return x, y, None, size, kw, True
    if name == "last row and column, origin and offset":
        size = (33, 65)
        x = np.concatenate([np.full(n // 2, 32.0 + 7),
                            rng.uniform(38, 40.5, n - n // 2)])
        y = np.concatenate([rng.uniform(0, 70, n // 2),
                            np.full(n - n // 2, 64.0 - 2.5)])
        kw = dict(origin=(7, -3), offset=(0.0, 0.5))
        return x, y, None, size, kw, False
    if name == "|x| = 1e9":
        size = (64, 96)
        x = rng.choice([1e9, -1e9, 5.0, 63.0], n)
        y = rng.choice([1e9, -1e9, 7.0, 95.0], n)
        return x, y, None, size, {"sign": torch.as_tensor(
            rng.integers(0, 2, n) * 2.0 - 1)}, True
    if name == "all invalid":
        size = (64, 96)
        x, y = rng.uniform(0, 63, n), rng.uniform(0, 95, n)
        kw = {"valid": torch.zeros(n, dtype=torch.bool)}
        return x, y, None, size, kw, True
    if name == "n = 0":
        return np.zeros(0), np.zeros(0), None, (64, 96), {}, True
    # every event in one 32x32 window
    size = (128, 192)
    x = rng.integers(64, 96, n).astype(float)
    y = rng.integers(128, 160, n).astype(float)
    pol = torch.as_tensor(rng.integers(0, 2, n) * 2.0 - 1)
    return x, y, None, size, {"polarity_planes": pol}, True


@pytest.mark.parametrize("name", [
    "719x1283, odd sizes",
    "pitch wider than the width, planes",
    "last row and column, origin and offset", "|x| = 1e9", "all invalid",
    "n = 0", "every event in one 32x32 window"])
def test_kernel_mirror_matches_plain(name):
    """The kernel's arithmetic, mirrored event by event in float32, element
    for element against the plain version: bit-equal on integer
    coordinates, ≤ 1e-5 where the fractional sums' order differs."""
    rng = np.random.default_rng(13)
    x, y, values, size, kw, exact = _mirror_case(name, rng)
    x, y = (torch.as_tensor(a, dtype=torch.float32) for a in (x, y))
    if values is not None:
        values = torch.as_tensor(values, dtype=torch.float32)
    got = _mirror(x, y, values, size, **kw)
    want = tcuda.hat_vote_plain(x, y, values, size, **kw)
    if "pitch" in kw:
        assert want.stride(-2) == kw["pitch"]
        full = want.as_strided(want.shape[:-1] + (kw["pitch"],),
                               want.stride(), want.storage_offset())
        assert not full[..., size[1]:].any()
    _compare(got, want, exact=exact)
    if name == "every event in one 32x32 window":
        assert float(got.sum()) == x.shape[0]
    if name in ("all invalid", "n = 0"):
        assert not got.any()


def test_hat_vote_checks_its_arguments_and_counts_nothing_on_cpu():
    kernels.reset_launches()
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        tcuda.hat_vote(x, x, None, (H, W), pitch=W - 1)
    with pytest.raises(ValueError):
        tcuda.hat_vote(x, x, None, (H, W), sign=x, polarity_planes=x)
    with pytest.raises(ValueError):
        tcuda.hat_vote(x, x, None, (H, W), polarity_planes=x, planes=3)
    with pytest.raises(ValueError):
        tcuda.hat_vote(x, x[:7], None, (H, W))
    img = tcuda.hat_vote(x, x, None, (H, W), planes=2,
                         plane=torch.ones(8, dtype=torch.int32))
    assert img.shape == (2, H, W) and float(img[1, 0, 0]) == 8.0
    assert kernels.launches["hat_vote_image"] == 0
