"""Solver layer: the generative model and the pyramidal patch solver."""

from . import generative, pyramid  # noqa: F401
from .generative import GenerativeSpec  # noqa: F401
from .pyramid import PyramidSpec, estimate_frame  # noqa: F401
