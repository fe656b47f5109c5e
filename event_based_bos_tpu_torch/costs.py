"""Functional cost layer.

PyTorch counterpart of the JAX package's ``costs.py``: each cost is a
function ``cost(arg: dict) -> scalar`` over the reference's argument keys
(``prediction``, ``measurement``, ``flow``, ``pxy``, ``weights``), and
:func:`hybrid_cost` returns a closure computing the weighted sum **and**
the per-term breakdown for the optimizer's history.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch

from .numerics import abs_
from .ops.gradients import central_gradient

__all__ = ["diff_norm", "flow_norm", "flow_norm_pxy", "image_gradient",
           "total_variation", "charbonnier", "image_variance",
           "gradient_magnitude", "normalized_image_variance", "functions",
           "hybrid_cost", "required_keys"]


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """Reduction accumulator dtype: float32 for bfloat16 inputs."""
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


def _safe_l2(v: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """L2 norm with a zero subgradient at the origin.

    ``torch.linalg.norm`` back-propagates NaN at an exactly-zero vector,
    which is the initial state of the translation field; the double
    ``where`` keeps the gradient there at 0.
    """
    sq = torch.sum((v * v).to(_acc_dtype(v)), dim=dim)
    zero = sq == 0
    safe = torch.where(zero, 1.0, sq)
    return torch.where(zero, 0.0, torch.sqrt(safe))


def diff_norm(arg: dict) -> torch.Tensor:
    """Induced matrix 1-norm of (prediction − measurement): the largest
    absolute column sum (sum over axis −2), not the entrywise L1.
    ``amax`` splits the gradient of tied columns evenly, as JAX's max."""
    d = abs_(arg["prediction"] - arg["measurement"])
    return torch.amax(torch.sum(d.to(_acc_dtype(d)), dim=-2))


def flow_norm(arg: dict) -> torch.Tensor:
    """Mean L2 magnitude of the flow field, channel axis first."""
    return torch.mean(_safe_l2(arg["flow"], dim=0))


def flow_norm_pxy(arg: dict) -> torch.Tensor:
    """Mean L2 magnitude of the translation (pxy) field."""
    return torch.mean(_safe_l2(arg["pxy"], dim=0))


def image_gradient(arg: dict) -> torch.Tensor:
    """Weighted smoothness of the ``[2, H, W]`` flow: central differences
    along both spatial axes (one-sided at the edges) times the per-pixel
    weights, mean of the absolute values."""
    flow = arg["flow"]
    w = arg.get("weights", None)
    if w is None:
        w = 1.0
    elif not torch.is_tensor(w):
        w = float(w)  # a Python number, not a host→device copy per call
    elif w.dim() == 0:
        w = w.expand(flow.shape[1:])
    acc = _acc_dtype(flow)
    total = 0.0
    for axis in (1, 2):
        n = flow.shape[axis]
        w_axis = axis - 1  # weights are [H, W]

        def wsl(a, b, _wa=w_axis):
            return w if isinstance(w, float) else w.narrow(_wa, a, b - a)

        upper = flow.narrow(axis, 2, n - 2)
        lower = flow.narrow(axis, 0, n - 2)
        total = total + torch.sum(abs_((upper - lower) * 0.5
                                       * wsl(1, n - 1)).to(acc))
        first = flow.narrow(axis, 1, 1) - flow.narrow(axis, 0, 1)
        last = flow.narrow(axis, n - 1, 1) - flow.narrow(axis, n - 2, 1)
        total = total + torch.sum(abs_(first * wsl(0, 1)).to(acc))
        total = total + torch.sum(abs_(last * wsl(n - 1, n)).to(acc))
    return total / flow.numel()


def total_variation(arg: dict) -> torch.Tensor:
    """Anisotropic TV of the flow (forward differences).

    ``arg["full_domain"] = (H, W)`` (set by the ROI-restricted solve)
    evaluates the full-frame TV from the cropped field: every nonzero
    difference lies inside the margin box (the masked flow is zero at and
    beyond its edge), so only the divisors change, ``(H−1)·W`` for the
    row differences and ``H·(W−1)`` for the column differences.
    """
    flow = arg["flow"]
    dx = abs_(flow[..., 1:, :] - flow[..., :-1, :])
    dy = abs_(flow[..., :, 1:] - flow[..., :, :-1])
    full = arg.get("full_domain")
    if full is None:
        return torch.mean(dx) + torch.mean(dy)
    h, w = full
    lead = flow.numel() // (flow.shape[-2] * flow.shape[-1])
    acc = _acc_dtype(flow)
    return (torch.sum(dx.to(acc)) / (lead * (h - 1) * w)
            + torch.sum(dy.to(acc)) / (lead * h * (w - 1)))


def charbonnier(arg: dict, alpha: float = 0.45,
                epsilon: float = 1e-3) -> torch.Tensor:
    """Robust Charbonnier penalty of (prediction − measurement).

    With ``arg["full_domain"] = (H, W)`` the full-frame mean is evaluated
    from the cropped residual: each pixel outside the box adds the
    constant ``ε^{2α}`` (zero gradient), in closed form.
    """
    delta = arg["prediction"] - arg["measurement"]
    vals = (delta ** 2 + epsilon ** 2) ** alpha
    full = arg.get("full_domain")
    if full is None:
        return torch.mean(vals)
    h, w = full
    n_full = vals.numel() // (vals.shape[-2] * vals.shape[-1]) * h * w
    n_out = n_full - vals.numel()
    return ((torch.sum(vals.to(_acc_dtype(vals)))
             + n_out * epsilon ** (2 * alpha)) / n_full)


def image_variance(arg: dict) -> torch.Tensor:
    """Variance of the IWE (contrast; higher = sharper), ddof 0 as
    ``jnp.var``."""
    return torch.var(arg["iwe"], correction=0)


def gradient_magnitude(arg: dict) -> torch.Tensor:
    """Mean squared central-difference gradient magnitude of the IWE (sharp
    IWEs have strong edges)."""
    iwe = arg["iwe"]
    gx = central_gradient(iwe, axis=-2)
    gy = central_gradient(iwe, axis=-1)
    return torch.mean(gx ** 2 + gy ** 2)


def normalized_image_variance(arg: dict) -> torch.Tensor:
    """The FWL ratio ``Var(IWE_orig) / Var(IWE)``; < 1 is better."""
    return (torch.var(arg["orig_iwe"], correction=0)
            / (torch.var(arg["iwe"], correction=0) + 1e-12))


#: Name → function registry (the generative and the contrast terms).
functions: Dict[str, Callable[[dict], torch.Tensor]] = {
    "diff_norm": diff_norm,
    "flow_norm": flow_norm,
    "flow_norm_pxy": flow_norm_pxy,
    "image_gradient": image_gradient,
    "total_variation": total_variation,
    "charbonnier": charbonnier,
    "image_variance": image_variance,
    "gradient_magnitude": gradient_magnitude,
    "normalized_image_variance": normalized_image_variance,
}

_REQUIRED_KEYS = {
    "diff_norm": ["prediction", "measurement"],
    "flow_norm": ["flow"],
    "flow_norm_pxy": ["pxy"],
    "image_gradient": ["flow", "omit_boundary"],
    "total_variation": ["flow"],
    "charbonnier": ["prediction", "measurement"],
    "image_variance": ["iwe"],
    "gradient_magnitude": ["iwe"],
    "normalized_image_variance": ["orig_iwe", "iwe"],
}


def required_keys(cost_with_weight: dict) -> list:
    """The argument keys the named terms read, in order (repeats kept)."""
    keys = []
    for name in cost_with_weight:
        keys.extend(_REQUIRED_KEYS.get(name, []))
    return keys


def hybrid_cost(cost_with_weight: Dict[str, Union[float, str, tuple]],
                direction: str = "minimize"
                ) -> Callable[[dict], Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]]:
    """Weighted-sum cost combinator returning ``(total, {name: raw})``.

    A weight ``"inv"`` adds the reciprocal of the term; ``("inv", s)`` adds
    ``1 / (raw · s)``.
    """
    if direction not in ("minimize", "maximize", "natural"):
        raise ValueError("direction should be minimize/maximize/natural, "
                         f"got {direction}")
    items = [(name, functions[name], w) for name, w in cost_with_weight.items()]
    sign = -1.0 if direction == "maximize" else 1.0

    def calculate(arg: dict):
        total = 0.0
        terms = {}
        for name, fn, w in items:
            raw = fn(arg)
            terms[name] = raw
            if w == "inv":
                total = total + 1.0 / raw
            elif isinstance(w, tuple) and w[0] == "inv":
                total = total + 1.0 / (raw * w[1])
            else:
                total = total + w * raw
        return sign * total, terms

    return calculate
