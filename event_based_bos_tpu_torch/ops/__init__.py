"""Numerical ops: plain PyTorch, plus the wrappers of the CUDA kernels (the
event vote and the binned CMax stencil)."""

from . import (cmax_cuda, events, gradients, image_warp, iwe,  # noqa: F401
               iwe_cuda, warp)
from .cmax_cuda import *  # noqa: F401,F403
from .gradients import *  # noqa: F401,F403
from .image_warp import *  # noqa: F401,F403
from .iwe import *  # noqa: F401,F403
from .iwe_cuda import *  # noqa: F401,F403
from .warp import *  # noqa: F401,F403
