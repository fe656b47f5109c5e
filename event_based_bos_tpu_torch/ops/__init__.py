"""Numerical ops: plain PyTorch, plus the CUDA vote kernel's wrappers."""

from . import gradients, image_warp, iwe, iwe_cuda  # noqa: F401
from .gradients import *  # noqa: F401,F403
from .image_warp import *  # noqa: F401,F403
from .iwe import *  # noqa: F401,F403
from .iwe_cuda import *  # noqa: F401,F403
