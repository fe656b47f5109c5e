"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in ``csrc/*.cu`` with a plain C interface:
``csrc/hat_vote.cu`` (the bilinear event vote, entry point
``ebt_vote``), ``csrc/cmax_stencil.cu`` (the time-binned CMax
stencil, ``ebt_cmax_stencil_fwd`` and ``ebt_cmax_stencil_bwd``),
``csrc/patch_objective.cu`` (the independent patch objective and its
gradient, ``ebt_patch_objective``) and ``csrc/graph_while.cu`` (a CUDA
graph with a conditional WHILE node,
``ebt_while_build``/``_launch``/``_destroy``, for
:class:`event_based_bos_tpu_torch.graphs.WhileGraph`).  At
first use each source is compiled by ``nvcc`` for ``sm_90a`` (all sources
at once, one ``nvcc`` process each), linked into one shared library under the
git-ignored ``build/kernels/`` directory beside the package, and loaded
with ``ctypes``.  The library name carries a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.

The module holds the loaded library handle and :data:`launches`, the
per-kernel launch counter that each wrapper bumps through
:func:`launched` exactly where it launches its kernel.  A launch made while
its stream captures a CUDA graph is not a launch: the capture records it
(:func:`recording`), and :mod:`event_based_bos_tpu_torch.graphs` adds the
recorded launches once per replay of the graph.  The WHILE node's
condition kernel runs as often as the data decides: it counts its own
launches in a device counter (:func:`device_counter`), which
:func:`device_launches` reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, List, Optional

__all__ = ["launches", "reset_launches", "launched", "recording",
           "device_counter", "device_launches", "build", "load", "library",
           "NVCC_FLAGS"]

SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name → launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"hat_vote_image": 0, "cmax_stencil_fwd": 0,
                            "cmax_stencil_bwd": 0, "patch_objective": 0}

#: kernel name → per-device launch counters that the kernel itself bumps
#: (int64 tensors of one element on the card, see :func:`device_counter`)
_device_counts: Dict[str, Dict[object, object]] = {"graph_while": {}}

_lib: Optional[ctypes.CDLL] = None

# the launches recorded by the capture under way (see :func:`recording`)
_tally: Optional[Dict[str, int]] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for counters in _device_counts.values():
        for counter in counters.values():
            counter.zero_()  # queued on the current stream, no read


def device_counter(name: str, device):
    """The device counter of kernel ``name`` on ``device``: one int64 that
    the kernel adds one to at each of its launches (made once, never moved:
    a captured graph holds its address)."""
    import torch

    device = torch.device(device)
    counters = _device_counts[name]
    if device not in counters:
        counters[device] = torch.zeros((1,), dtype=torch.int64,
                                       device=device)
    return counters[device]


def device_launches(name: str) -> int:
    """Launches of kernel ``name`` since the last :func:`reset_launches`,
    summed over its device counters (one read of each)."""
    return sum(int(c.item()) for c in _device_counts[name].values())


def launched(name: str) -> None:
    """Count one launch of kernel ``name`` on the current stream.  While
    that stream captures a CUDA graph inside :func:`recording`, the launch
    goes to the capture's tally instead (the kernel runs at each replay,
    not now)."""
    if _tally is not None and _capturing():
        _tally[name] = _tally.get(name, 0) + 1
    else:
        launches[name] += 1


def _capturing() -> bool:
    import torch

    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


@contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Collect the launches made on a capturing stream inside the block
    (the autograd thread's backward launches too) into the dict it
    yields, kernel name → launches a replay."""
    global _tally
    if _tally is not None:
        raise RuntimeError("a capture is already recording launches")
    _tally = {}
    try:
        yield _tally
    finally:
        _tally = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _lib_path(sources: List[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libebt_kernels_{h.hexdigest()[:16]}.so"


def build(sources: Optional[List[Path]] = None) -> Dict[str, object]:
    """Compile every ``csrc/*.cu`` (or the ``sources`` given, e.g. an
    earlier revision of a kernel for an A/B) in parallel and link the
    library.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds nvcc's output,
    including ``ptxas``' register and spill report.  Raises on failure.
    """
    sources = _sources() if sources is None else [Path(s) for s in sources]
    out = _lib_path(sources)
    if out.is_file():
        return {"path": str(out), "seconds": 0.0, "log": "cached"}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        for src, _obj, p in procs:
            text, _ = p.communicate()
            log.append(f"[{src.name}]\n{text}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _s, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)  # atomic: concurrent builders agree
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "log": "\n".join(log)}


def load(path: str) -> ctypes.CDLL:
    """Load a library built by :func:`build` and declare the entry points
    it has."""
    lib = ctypes.CDLL(path)
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    vote = [p, p, p, p, i, p, f, p, i, ll, f, f, i, i, i, i, i, i, p, p]
    for name, args in (("ebt_vote", vote),
                       ("ebt_cmax_stencil_fwd",
                        [p, p, p, i, i, i, i, i, p, p]),
                       ("ebt_cmax_stencil_bwd",
                        [p, p, p, p, i, i, i, i, i, p, p, p]),
                       ("ebt_patch_objective",
                        [p, p, p, p, ll, f, f, p, p, p]),
                       ("ebt_while_build", [p, p, p, p, p, p]),
                       ("ebt_while_launch", [p, p]),
                       ("ebt_while_destroy", [p])):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = load(build()["path"])
    return _lib
