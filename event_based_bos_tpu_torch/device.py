"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the GPU.  The CPU is
used only when the caller asks for it (``device="cpu"``, as the tests do):
a machine without a GPU raises rather than quietly running the solve on
the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; a CUDA request without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev
