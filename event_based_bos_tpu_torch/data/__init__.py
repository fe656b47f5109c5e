"""Data sources of the port: the synthetic BOS generator."""

from . import synthetic  # noqa: F401
