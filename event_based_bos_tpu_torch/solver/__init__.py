"""Solver layer: the generative model, the pyramidal patch solver and the
contrast-maximization (CMax) solver."""

from . import cmax, generative, pyramid  # noqa: F401
from .cmax import (CmaxSpec, estimate_frame_cmax,  # noqa: F401
                   solve_cmax_dense, solve_cmax_translation)
from .generative import GenerativeSpec  # noqa: F401
from .pyramid import PyramidSpec, estimate_frame  # noqa: F401
