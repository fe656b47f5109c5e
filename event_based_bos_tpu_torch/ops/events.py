"""Event-batch helpers.

PyTorch counterpart of the part of the JAX package's ``ops/events.py`` that
the warps and the CMax solver use: the masked min/max over live events.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = []


def _masked_min_max(v: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min and max of ``v`` over the slots where ``valid`` (last axis);
    ``+inf`` / ``−inf`` when no slot is live."""
    big = torch.tensor(torch.inf, dtype=v.dtype, device=v.device)
    vmin = torch.amin(torch.where(valid, v, big), dim=-1)
    vmax = torch.amax(torch.where(valid, v, -big), dim=-1)
    return vmin, vmax
