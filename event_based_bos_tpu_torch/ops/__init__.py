"""Numerical ops: plain PyTorch, plus the wrappers of the CUDA kernels (the
event vote and the binned CMax stencil), the event filters, the flow
utilities and metrics, the voxel grids, the statistics and the DST
Poisson integration."""

from . import (cmax_cuda, events, filters, flow, gradients,  # noqa: F401
               image_warp, iwe, iwe_cuda, poisson, stats, voxel, warp)
from .cmax_cuda import *  # noqa: F401,F403
from .events import *  # noqa: F401,F403
from .filters import *  # noqa: F401,F403
from .flow import *  # noqa: F401,F403
from .gradients import *  # noqa: F401,F403
from .image_warp import *  # noqa: F401,F403
from .iwe import *  # noqa: F401,F403
from .iwe_cuda import *  # noqa: F401,F403
from .poisson import *  # noqa: F401,F403
from .stats import *  # noqa: F401,F403
from .voxel import *  # noqa: F401,F403
from .warp import *  # noqa: F401,F403
