"""Solver layer: the generative model, the pyramidal patch solver, the
contrast-maximization (CMax) solver, and the facades the CLI builds from
the YAML config (``collections``)."""

from . import api, cmax, facades, generative, programs, pyramid  # noqa: F401
from .api import EstimationHandle, SolverBase  # noqa: F401
from .cmax import (CmaxSpec, estimate_frame_cmax,  # noqa: F401
                   solve_cmax_dense, solve_cmax_translation)
from .facades import (ContrastMaximization, PatchEkltPyramid2,  # noqa: F401
                      collections)
from .generative import GenerativeSpec  # noqa: F401
from .pyramid import PyramidSpec, estimate_frame  # noqa: F401
