"""Elementwise helpers whose gradients follow JAX's conventions.

Autodiff of ``|x|`` differs between the frameworks at ``x = 0``: torch
gives 0, JAX's rule is ``select(x >= 0, g, -g)``, i.e. +1.  The solve
starts with the translation field at exactly 0, where the pattern-shift
warp takes ``|pxy|``: with torch's rule the translation gets no gradient
and never moves.  The port therefore uses :func:`abs_` wherever an
absolute value is differentiated.
"""

from __future__ import annotations

import torch

__all__ = ["abs_"]


def abs_(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's derivative: +1 at 0 (and at −0.0)."""
    return torch.where(x >= 0, x, -x)
