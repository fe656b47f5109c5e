"""The in-repo static lint (``tools/lint.py``) over the PyTorch port."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_port_lint_clean():
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "lint.py"),
         "event_based_bos_tpu_torch", "chip_smoke.py",
         "tools/torch_solve_probe.py", "tools/stencil_ab.py"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert ", 0 problems" in out.stdout
