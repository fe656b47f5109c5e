"""event_based_bos_tpu_torch — the PyTorch/CUDA port of event-based BOS.

The second implementation of the event-based Background-Oriented Schlieren
solver, beside the JAX package ``event_based_bos_tpu`` (the reference it is
tested against).  Plain tensor code is PyTorch; the per-frame event vote,
which the JAX package wrote as a Pallas TPU kernel, is a hand-written CUDA
kernel for Hopper (``csrc/hat_vote.cu``, bound in
:mod:`event_based_bos_tpu_torch.ops.iwe_cuda`).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
GPU present they raise instead of falling back to the CPU
(:func:`event_based_bos_tpu_torch.device.resolve_device`).

Subpackages:
  * :mod:`event_based_bos_tpu_torch.ops` — IWE vote and blur, Sobel,
    resize and pattern-shift warp, event filters, voxel grids, flow
    utilities and metrics.
  * :mod:`event_based_bos_tpu_torch.costs` — the functional cost registry.
  * :mod:`event_based_bos_tpu_torch.solver` — the generative model and the
    pyramidal patch solver.
  * :mod:`event_based_bos_tpu_torch.piv` — multipass window-deformation
    PIV.
  * :mod:`event_based_bos_tpu_torch.data` — the synthetic BOS generator
    and the dataset loaders.
"""

__version__ = "0.1.0"

from . import ops, types  # noqa: F401
from .device import resolve_device  # noqa: F401
from .types import (  # noqa: F401
    Events,
    FlowPatch,
    PatchGrid,
    events_from_arrays,
    events_from_ndarray,
)
