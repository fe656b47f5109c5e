"""Solver layer: the generative model, the whole-ROI (GML), tiled and
pyramidal patch solvers, the contrast-maximization (CMax) solver, and the
facades the CLI builds from the YAML config (``collections``)."""

from . import (api, cmax, evolution, facades, generative, gml,  # noqa: F401
               patch, programs, pyramid)
from .api import EstimationHandle, SolverBase  # noqa: F401
from .cmax import (CmaxSpec, estimate_frame_cmax,  # noqa: F401
                   solve_cmax_dense, solve_cmax_translation)
from .facades import (ContrastMaximization,  # noqa: F401
                      GenerativeMaximumLikelihood, PatchEklt,
                      PatchEkltDependent, PatchEkltPyramid2, collections)
from .generative import GenerativeSpec  # noqa: F401
from .gml import GmlSpec, estimate_frame_gml  # noqa: F401
from .patch import (PatchSpec, estimate_frame_dependent,  # noqa: F401
                    estimate_frame_patch)
from .pyramid import PyramidSpec, estimate_frame  # noqa: F401
