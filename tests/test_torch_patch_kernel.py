"""The independent patch objective's kernel (``ops/patch_cuda.py``,
``csrc/patch_objective.cu``) and the solve's choice of it.

On the CPU:

* the kernel's plain specification, each patch's loss and hand-derived
  gradient, against autograd of the vmapped ``solver/patch.py::
  _patch_objective`` in float64 and float32: random windows, the zero
  prediction (θ = 0), all four columns tied (all-zero windows too),
  shifts that move taps out of the window (|p| > 1, negative p, p on an
  integer, the floor's kink) and the pattern shift at the origin;
* the cost's ``image_gradient`` term, which the kernel leaves out: over a
  patch's constant flow it adds exactly 0 to the vmapped objective's loss
  and only rounding noise to its gradient;
* the autograd wrapper: its backward scales each patch's gradient by the
  loss's cotangent, refuses a second derivative, and checks its inputs;
* the path an independent solve takes: the kernel for a covered spec with
  float32 windows on the card (on the CPU, where the kernel cannot run,
  the decision is taken on stand-in buffers, and a solve whose windows are
  let through runs the wrapper's plain route), the vmapped objective for
  an uncovered spec, bfloat16 windows and the CPU, with
  ``patch.kernel_fits`` counting the patches fitted through the kernel.

On the card (``card`` marker; run there with ``python -m pytest
--noconftest tests/test_torch_patch_kernel.py -q -m card``: this file
imports no JAX, the suite's ``conftest.py`` does), at ``patch_eklt``'s
full grid of 229,401 patches on one of the cell's windows:

* the kernel against the plain specification in float64;
* a whole kept solve through the kernel against the vmapped solve, within
  ``perfbench/configs/patch_eklt.json``'s limits;
* one kernel launch a step of a kept solve, under graph replay;
* the wrapper refusing a float64, non-contiguous or unaligned CUDA
  tensor.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from event_based_bos_tpu_torch import costs as tcosts
from event_based_bos_tpu_torch import kernels
from event_based_bos_tpu_torch.ops import patch_cuda
from event_based_bos_tpu_torch.solver import generative as tgen
from event_based_bos_tpu_torch.solver import patch as tpatch
from event_based_bos_tpu_torch.utils import tracing

N = 96                      # patches a CPU case
COSTS = {
    "cell": (("diff_norm", 1.0), ("image_gradient", 0.5),
             ("flow_norm_pxy", 0.1)),
    "no_pxy": (("diff_norm", 2.0), ("image_gradient", 0.5)),
}
#: spec against autograd: the same arithmetic, summed in another order
TOL = {torch.float64: 1e-12, torch.float32: 2e-5}


def _spec(dtype, cost="cell", size=(8, 8), **gen):
    kw = dict(image_size=size, dtype=dtype, cost_weights=COSTS[cost],
              poisson_model=False)
    kw.update(gen)
    return tpatch.PatchSpec(gen=tgen.GenerativeSpec(**kw),
                            roi=(0, size[0], 0, size[1]))


def _normalized(m):
    norm = np.sqrt((m * m).reshape(len(m), -1).sum(1))
    return m / np.maximum(norm, 1e-30)[:, None, None]


def _case(name, rng):
    """``(theta [N, 4], measured, gx, gy, wi [N, 4, 4])`` as float64 (the
    kernel reads no ``wi``: the vmapped objective's smoothness does)."""
    theta = np.concatenate([rng.normal(0, 1.5, (N, 2)),
                            rng.uniform(-0.9, 0.9, (N, 2))], 1)
    m = _normalized(rng.normal(0, 1, (N, 4, 4)))
    gx, gy = rng.normal(0, 40, (2, N, 4, 4))
    wi = rng.uniform(0.05, 1.0, (N, 4, 4))
    if name == "zero_theta":
        theta[:] = 0.0
    elif name == "tied_columns":
        # identical columns (the shift at 0 samples them as they are), and
        # a quarter of the patches all zero: every column ties
        col = rng.normal(0, 40, (2, N, 4, 1))
        gx, gy = np.repeat(col, 4, axis=3)
        m = _normalized(np.repeat(rng.normal(0, 1, (N, 4, 1)), 4, axis=2))
        theta[:, 2:] = 0.0
        gx[::4] = gy[::4] = m[::4] = 0.0
        theta[1::8] = 0.0
    elif name == "taps_outside":
        # |p| > 1, negative p, p on an integer (the floor's kink)
        theta[:, 2:] = rng.choice([-4.5, -2.0, -1.25, -1.0, -0.5, 0.0, 1.0,
                                   1.75, 2.0, 3.5, 5.0], (N, 2))
    elif name == "pxy_origin":
        theta[:, 2:] = 0.0
    return theta, m, gx, gy, wi


def _autograd(theta, windows, spec):
    """Each patch's loss and gradient through the solve's vmapped
    objective and autograd, as the loop takes them; ``windows`` are
    ``(measured, gx, gy, wi)``."""
    def one(t, m, a, b, wi):
        return tpatch._patch_objective(t, m, a, b, wi, None, spec)

    x = theta.clone().requires_grad_(True)
    loss = torch.func.vmap(one)(x, *windows)
    (grad,) = torch.autograd.grad(loss.sum(), x)
    return loss.detach(), grad


def _rel(got, want):
    """Largest per-patch error over the larger of the patch's largest
    magnitude and 1: autograd's ``image_gradient`` of a constant flow adds
    rounding noise (~ε) where the spec has none, which sets a whole
    gradient of a blank window."""
    got, want = got.reshape(len(got), -1), want.reshape(len(want), -1)
    scale = want.abs().amax(1).clamp(min=1.0)
    return float(((got - want).abs().amax(1) / scale).max())


@pytest.mark.parametrize("cost", sorted(COSTS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["random", "zero_theta", "tied_columns",
                                  "taps_outside", "pxy_origin"])
def test_plain_spec_is_autograd_of_the_vmapped_objective(case, dtype, cost):
    rng = np.random.default_rng(sorted(COSTS).index(cost) * 10 + len(case))
    theta, *windows = (torch.as_tensor(a, dtype=dtype)
                       for a in _case(case, rng))
    spec = _spec(dtype, cost)
    weights = patch_cuda.term_weights(spec.gen.cost_weights)
    loss, grad = patch_cuda.patch_objective_plain(theta, *windows[:3],
                                                  weights)
    want_loss, want_grad = _autograd(theta, windows, spec)
    assert loss.dtype == grad.dtype == dtype
    assert _rel(loss[:, None], want_loss[:, None]) <= TOL[dtype]
    assert _rel(grad, want_grad) <= TOL[dtype], (grad, want_grad)
    if case == "zero_theta":
        # the zero prediction's subgradient: no NaN, and the velocity
        # moves (the pattern shift's derivative at 0 is the norm's 0)
        assert torch.isfinite(grad).all()
        assert (grad[:, :2] != 0).any()
    if case == "tied_columns":
        assert torch.equal(grad[::4], torch.zeros_like(grad[::4]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["random", "zero_theta", "tied_columns",
                                  "taps_outside", "pxy_origin"])
def test_the_smoothness_of_a_constant_patch_flow_adds_nothing(case, dtype):
    rng = np.random.default_rng(100 + len(case))
    theta, *windows = (torch.as_tensor(a, dtype=dtype)
                       for a in _case(case, rng))
    with_term, _ = _autograd(theta, windows, _spec(dtype, "cell"))
    without = _spec(dtype, "cell")
    without = dataclasses.replace(without, gen=dataclasses.replace(
        without.gen, cost_weights=tuple(
            (k, w) for k, w in COSTS["cell"] if k != "image_gradient")))
    want, _ = _autograd(theta, windows, without)
    assert torch.equal(with_term, want)
    # its gradient: the weighted differences of v − v, back into v
    x = theta[:, :2].clone().requires_grad_(True)
    flow = x[:, :, None, None].expand(N, 2, 4, 4)
    smooth = torch.func.vmap(lambda f, wi: tcosts.image_gradient(
        {"flow": f, "weights": wi}))(flow, windows[3])
    (grad,) = torch.autograd.grad(smooth.sum(), x)
    assert torch.equal(smooth, torch.zeros_like(smooth))
    assert float(grad.abs().max()) <= 64 * torch.finfo(dtype).eps


def test_the_wrapper_scales_by_the_cotangent_and_checks_its_inputs():
    rng = np.random.default_rng(5)
    theta, *windows = (torch.as_tensor(a) for a in _case("random", rng))
    windows = windows[:3]
    weights = patch_cuda.term_weights(COSTS["cell"])
    assert weights == (1.0, 0.1)
    x = theta.clone().requires_grad_(True)
    cot = torch.as_tensor(rng.uniform(-2, 2, N))
    loss = patch_cuda.patch_objective(x, *windows, weights)
    (grad,) = torch.autograd.grad(loss, x, cot)
    want_loss, want_grad = patch_cuda.patch_objective_plain(theta, *windows,
                                                            weights)
    assert torch.equal(loss.detach(), want_loss)
    assert torch.equal(grad, cot[:, None] * want_grad)
    loss = patch_cuda.patch_objective(x, *windows, weights)
    with pytest.raises(RuntimeError, match="second derivative"):
        torch.autograd.grad(loss.sum(), x, create_graph=True)
    with pytest.raises(ValueError, match="theta must be"):
        patch_cuda.patch_objective_fwd(theta[:, :3], *windows, weights)
    with pytest.raises(ValueError, match="gx must be"):
        patch_cuda.patch_objective_fwd(theta, windows[0], windows[1][:, :3],
                                       *windows[2:], weights)
    with pytest.raises(ValueError, match="device and dtype"):
        patch_cuda.patch_objective_fwd(theta, windows[0].float(),
                                       *windows[1:], weights)


def test_term_weights_take_the_kernels_terms_with_numeric_weights():
    assert patch_cuda.term_weights(COSTS["no_pxy"]) == (2.0, 0.0)
    assert patch_cuda.term_weights({"diff_norm": 1}) == (1.0, 0.0)
    for cost in ({"diff_norm": 1.0, "total_variation": 0.1},
                 {"diff_norm": "inv"}, {"diff_norm": ("inv", 2.0)},
                 {"diff_norm": True}):
        assert patch_cuda.term_weights(cost) is None, cost


# ---------------------------------------------------------------------------
# the path an independent solve takes
# ---------------------------------------------------------------------------

SIZE = (16, 22)
N_ITER = 5


def _stand_ins(device, dtype, w_p=False):
    """Buffers with the device and dtype of the kept windows, for the
    decision alone."""
    t = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    bufs = {k: t for k in tpatch.KERNEL_WINDOWS}
    bufs["w_p"] = t if w_p else None
    return bufs


def _frame_constants(seed=1):
    """``(histogram, weight_inverse, gx, gy, active)`` of a small random
    frame, float32 on the CPU."""
    rng = np.random.default_rng(seed)
    h, w = SIZE
    hist, gx, gy = (torch.as_tensor(rng.normal(0, s, (h, w)),
                                    dtype=torch.float32)
                    for s in (1.0, 30.0, 30.0))
    wi = torch.as_tensor(rng.uniform(0.1, 1.0, (h, w)), dtype=torch.float32)
    grid = _spec(torch.float32, size=SIZE).grid
    active = torch.as_tensor(grid.roi_mask(2, h - 2, 4, w - 4),
                             dtype=torch.float32)
    return hist, wi, gx, gy, active


def _solve(spec, consts):
    hist, wi, gx, gy, active = consts
    program = tpatch.PatchProgram(dataclasses.replace(spec, n_iter=N_ITER),
                                  joint=False)
    before = tracing.counters()
    _flow, aux = program.solve_independent(hist, None, wi, gx, gy, active)
    after = tracing.counters()
    grown = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("patch.fits", "patch.kernel_fits")}
    return program, aux, grown


UNCOVERED = {
    "angle_model": dict(angle_model=True),
    "no_polarity": dict(no_polarity=True),
    "no_warp": dict(optimize_warp=False),
    "inverse_weight": dict(cost_weights=(("diff_norm", "inv"),)),
    "another_term": dict(cost_weights=(("diff_norm", 1.0),
                                       ("total_variation", 0.5))),
}


@pytest.mark.parametrize("case", ["covered_on_card", "uncovered_spec",
                                  "bfloat16_windows", "cpu"])
def test_the_solve_picks_its_objective_from_the_spec_and_the_buffers(
        case, monkeypatch):
    spec = _spec(torch.float32, size=SIZE)
    n_patch = spec.grid.n_patch
    consts = _frame_constants()
    if case == "covered_on_card":
        assert tpatch._kernel_weights(
            spec, _stand_ins("cuda", torch.float32)) == (1.0, 0.1)
        assert tpatch._kernel_weights(
            spec, _stand_ins("cuda", torch.float32, w_p=True)) is None
        assert tpatch._kernel_weights(dataclasses.replace(
            spec, patch_size=6), _stand_ins("cuda", torch.float32)) is None
        # the kernel cannot run here: let the CPU's float32 windows through
        # the decision, and the wrapper runs its plain route in the loop
        _, want, grown_v = _solve(spec, consts)
        monkeypatch.setattr(tpatch, "_card_float32",
                            lambda t: t.dtype == torch.float32)
        program, got, grown = _solve(spec, consts)
        assert program.on_kernel
        assert grown == {"patch.fits": n_patch, "patch.kernel_fits": n_patch}
        assert grown_v == {"patch.fits": n_patch, "patch.kernel_fits": 0}
        for key in ("history", "losses", "thetas"):
            torch.testing.assert_close(got[key], want[key], rtol=2e-5,
                                       atol=2e-5 * float(
                                           want[key].abs().max()))
        return
    if case == "uncovered_spec":
        for name, gen in UNCOVERED.items():
            other = _spec(torch.float32, size=SIZE, **gen)
            assert tpatch._kernel_weights(
                other, _stand_ins("cuda", torch.float32)) is None, name
        other = _spec(torch.float32, size=SIZE, **UNCOVERED["no_polarity"])
        monkeypatch.setattr(tpatch, "_card_float32", lambda t: True)
        program, _aux, grown = _solve(other, consts)
    elif case == "bfloat16_windows":
        assert tpatch._kernel_weights(
            spec, _stand_ins("cuda", torch.bfloat16)) is None
        monkeypatch.setattr(tpatch, "_card_float32",
                            lambda t: t.dtype == torch.float32)
        cut = tpatch._patch_constants
        monkeypatch.setattr(tpatch, "_patch_constants", lambda *a, **k: {
            key: None if v is None else v.to(torch.bfloat16)
            for key, v in cut(*a, **k).items()})
        program, _aux, grown = _solve(spec, consts)
    else:
        assert tpatch._kernel_weights(
            spec, _stand_ins("cpu", torch.float32)) is None
        program, _aux, grown = _solve(spec, consts)
    assert not program.on_kernel
    assert grown == {"patch.fits": n_patch, "patch.kernel_fits": 0}


# ---------------------------------------------------------------------------
# on the card, at patch_eklt's grid
# ---------------------------------------------------------------------------

CARD_SEED = 2147483713
#: kernel against the float64 spec: each patch's loss, and each patch's
#: gradient but at a handful of patches on a kink of the objective (a
#: difference within rounding of 0, or the largest column within rounding
#: of another), where float32 and float64 take different one-sided
#: gradients
CARD_LOSS_REL, CARD_GRAD_REL, CARD_KINK_SHARE = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def cell_window(card):
    """The ``patch_eklt.sync`` cell's spec and limits, and one window's
    frame constants on the card."""
    from perfbench import harness, scenes

    _b, _s, config, traffic = harness.cell_spec("patch_eklt.sync")
    scene = scenes.load(traffic["scene"])
    (win,) = scene.make_windows(tuple(config["image_size"]), 1,
                                int(traffic["events_per_window"]),
                                traffic["scene_params"], CARD_SEED)
    facade = harness.build_facade(config, CARD_SEED, card)
    ev, _period = facade.preprocess(win.events)
    frame = facade._frame({"frame": win.frame})
    spec = facade.spec
    ev, gx, gy, hist, weights, wi = tgen.frame_constants(ev, frame, spec.gen,
                                                         card, None)
    active = tpatch.active_patch_mask(ev, spec)
    return (spec, config["correct"]["limits"],
            (hist, weights, wi, gx, gy, active))


def _card_theta(n, device):
    g = torch.Generator(device="cpu").manual_seed(CARD_SEED)
    theta = torch.cat([torch.randn((n, 2), generator=g) * 1.5,
                       torch.rand((n, 2), generator=g) * 4 - 2], 1)
    theta[0::7] = 0.0                                  # the zero prediction
    theta[1::7, 2:] = torch.randint(-2, 3, (len(theta[1::7]), 2),
                                    generator=g).float()   # on the kink
    theta[2::7, 2:] = 0.0                              # pxy at the origin
    return theta.to(device)


@pytest.mark.card
def test_card_kernel_matches_the_plain_spec_at_the_cells_grid(cell_window):
    spec, _limits, (hist, weights, wi, gx, gy, _active) = cell_window
    consts = tpatch._patch_constants(hist, weights, wi, gx, gy, spec)
    windows = [consts[k].contiguous() for k in tpatch.KERNEL_WINDOWS]
    n = windows[0].shape[0]
    assert n == spec.grid.n_patch == 229_401
    weights_ = tpatch._kernel_weights(spec, consts)
    assert weights_ == (1.0, 0.1)
    theta = _card_theta(n, hist.device)
    kernels.reset_launches()
    loss, grad = patch_cuda.patch_objective_fwd(theta, *windows, weights_)
    torch.cuda.synchronize()
    assert kernels.launches["patch_objective"] == 1
    want_loss, want_grad = patch_cuda.patch_objective_plain(
        theta.double(), *(w.double() for w in windows), weights_)
    loss_rel = ((loss.double() - want_loss).abs()
                / want_loss.abs().clamp(min=1e-30))
    grad_rel = ((grad.double() - want_grad).norm(dim=1)
                / want_grad.norm(dim=1).clamp(min=1e-30))
    off = int((grad_rel > CARD_GRAD_REL).sum())
    print(f"patch objective kernel vs float64 spec, {n} patches: loss max "
          f"rel {float(loss_rel.max()):.3e}, gradient max rel "
          f"{float(grad_rel.max()):.3e}, {off} patches above "
          f"{CARD_GRAD_REL:g}, median {float(grad_rel.median()):.3e}")
    assert float(loss_rel.max()) <= CARD_LOSS_REL
    assert off <= CARD_KINK_SHARE * n
    assert torch.isfinite(grad).all()


def _summed(x, active):
    return float(torch.dot(x.reshape(-1).double(),
                           active.reshape(-1).double()))


@pytest.mark.card
def test_card_kernel_solve_matches_the_vmapped_solve(cell_window,
                                                     monkeypatch):
    spec, limits, (hist, weights, wi, gx, gy, active) = cell_window
    program = tpatch.PatchProgram(spec, joint=False)
    _flow, got = program.solve_independent(hist, weights, wi, gx, gy, active)
    assert program.on_kernel
    monkeypatch.setattr(tpatch, "_kernel_weights", lambda *a: None)
    vmapped = tpatch.PatchProgram(spec, joint=False)
    _flow, want = vmapped.solve_independent(hist, weights, wi, gx, gy,
                                            active)
    assert not vmapped.on_kernel
    h_got, h_want = got["history"].double(), want["history"].double()
    loss_gap = float(((h_got - h_want).abs() / h_want.abs()).max())
    best_gap = abs(_summed(got["losses"], active)
                   / _summed(want["losses"], active) - 1)
    on = active.reshape(-1) > 0
    v_got, v_want = got["thetas"][on, :2], want["thetas"][on, :2]
    off = ((v_got - v_want).norm(dim=1)
           / v_want.norm(dim=1).mean()).double()
    fit_gap, fit_share = float(off.median()), float((off > 0.1).double()
                                                    .mean())
    print(f"kernel solve vs vmapped solve, {int(on.sum())} active patches, "
          f"{spec.n_iter} steps: history gap {loss_gap:.3e}, best losses "
          f"{best_gap:.3e}, patch flow median {fit_gap:.3e}, share > 0.1 "
          f"{fit_share:.3e}")
    assert loss_gap <= limits["loss_gap"]
    assert best_gap <= limits["loss_gap"]
    assert fit_gap <= limits["fit_gap"]
    assert fit_share <= limits["fit_share"]


@pytest.mark.card
def test_card_kept_solve_launches_the_kernel_once_a_step(cell_window):
    spec, _limits, (hist, weights, wi, gx, gy, active) = cell_window
    program = tpatch.PatchProgram(spec, joint=False)
    for _solve_index in range(2):
        kernels.reset_launches()
        before = tracing.counters()
        program.solve_independent(hist, weights, wi, gx, gy, active)
        torch.cuda.synchronize()
        after = tracing.counters()
        assert program.kept.loops[0].graph is not None
        assert kernels.launches["patch_objective"] == spec.n_iter
        fits = {k: after[k] - before.get(k, 0)
                for k in ("patch.fits", "patch.kernel_fits")}
        assert fits == {"patch.fits": spec.grid.n_patch,
                        "patch.kernel_fits": spec.grid.n_patch}


@pytest.mark.card
def test_card_wrapper_refuses_float64_strided_and_unaligned_tensors(card):
    theta = torch.zeros((8, 4), dtype=torch.float64, device=card)
    windows = [torch.zeros((8, 4, 4), dtype=torch.float64, device=card)
               for _ in tpatch.KERNEL_WINDOWS]
    with pytest.raises(TypeError, match="float32"):
        patch_cuda.patch_objective_fwd(theta, *windows, (1.0, 0.1))
    theta = torch.zeros((4, 8), device=card).T
    windows = [torch.zeros((8, 4, 4), device=card)
               for _ in tpatch.KERNEL_WINDOWS]
    with pytest.raises(ValueError, match="contiguous"):
        patch_cuda.patch_objective_fwd(theta, *windows, (1.0, 0.1))
    theta = torch.zeros((33,), device=card)[1:].reshape(8, 4)
    with pytest.raises(ValueError, match="16 bytes"):
        patch_cuda.patch_objective_fwd(theta, *windows, (1.0, 0.1))
