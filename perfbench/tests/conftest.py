"""The benchmark's own tests: ``python -m pytest perfbench/tests -q``.

Tests that need the card carry the ``card`` marker and decide inside the
test whether there is one.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA GPU (skips without one)")
