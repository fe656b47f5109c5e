"""The port's ctypes binding of the native host runtime
(``native/ebt_runtime.cpp``).

Host-side event-stream passes at memory speed: the timestamp search
(:func:`searchsorted`), the padded window extraction
(:func:`window_padded`), the exact sequential background-activity and
hot-pixel filters (:func:`baf_filter`, :func:`hot_pixel_filter`) and the
Prophesee EVT3 decoder (:func:`decode_evt3`).  Each has its plain version
beside it (``*_plain``: numpy, or a Python loop for the decoder) with the
same results.

At first use the C++ source is compiled with ``g++`` and the flags of
``native/Makefile`` into ``build/runtime/`` beside the package (git
ignored); the library name carries a hash of the source, the flags and the
host name, so an edited source, or a checkout copied to another machine,
is rebuilt.  Nothing is written into ``native/``.  Where the build fails,
one warning is logged and every function takes its plain version;
:func:`available` says which route runs.  :func:`ensure_built` builds
ahead of first use, or again with ``force``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["available", "ensure_built", "library_path", "searchsorted",
           "searchsorted_plain", "window_padded", "window_padded_plain",
           "baf_filter", "baf_filter_plain", "hot_pixel_filter",
           "hot_pixel_filter_plain", "decode_evt3", "decode_evt3_plain"]

_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "native" / "ebt_runtime.cpp"
BUILD_DIR = _ROOT / "build" / "runtime"
#: ``native/Makefile``'s CXXFLAGS
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    """Where the library of this source, these flags and this host goes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(platform.node().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libebt_runtime_{h.hexdigest()[:16]}.so"


def _build(force: bool = False) -> Path:
    out = library_path()
    if out.is_file() and not force:
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / out.name
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-shared", "-o", str(tmp_lib), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stdout}")
        os.replace(tmp_lib, out)  # atomic: concurrent builders agree
    return out


def ensure_built(force: bool = False) -> bool:
    """Build the library under ``build/runtime/`` if it is missing (with
    ``force``, again even where it exists, and after an earlier failure);
    returns whether it is there.  A failure logs one warning and makes
    every function take its plain version."""
    global _failed
    if force:
        _failed = False
    elif _failed:
        return False
    try:
        _build(force)
    except (OSError, RuntimeError) as e:
        _failed = True
        logger.warning("native runtime unavailable, using the numpy "
                       "versions: %s", e)
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None (after one warning)
    where it cannot be built."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    if not ensure_built():
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError as e:
        _failed = True
        logger.warning("native runtime unavailable, using the numpy "
                       "versions: %s", e)
        return None
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    u8, u16, i16, f32 = (ctypes.c_uint8, ctypes.c_uint16, ctypes.c_int16,
                         ctypes.c_float)
    P = ctypes.POINTER
    lib.ebt_searchsorted_i32.restype = i64
    lib.ebt_searchsorted_i32.argtypes = [P(i32), i64, i32]
    lib.ebt_searchsorted_f64.restype = i64
    lib.ebt_searchsorted_f64.argtypes = [P(f64), i64, f64]
    lib.ebt_window_padded.restype = i64
    lib.ebt_window_padded.argtypes = [P(i16), P(i16), P(i32), P(u8),
                                      i64, i64, i64,
                                      P(f32), P(f32), P(f32), P(f32), P(u8)]
    lib.ebt_baf_filter.restype = None
    lib.ebt_baf_filter.argtypes = [P(f64), i64, i64, i64, f64, i64, i64,
                                   P(f64), P(u8)]
    lib.ebt_hot_pixel_filter.restype = None
    lib.ebt_hot_pixel_filter.argtypes = [P(f64), i64, i64, i64, f64,
                                         P(i32), P(u8)]
    lib.ebt_decode_evt3.restype = i64
    lib.ebt_decode_evt3.argtypes = [P(u16), i64, i64, P(i16), P(i16),
                                    P(i32), P(u8)]
    _lib = lib
    return lib


def available() -> bool:
    """True where the native library is built and loaded."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# Timestamp search
# ---------------------------------------------------------------------------

def searchsorted_plain(t: np.ndarray, query) -> int:
    return int(np.searchsorted(t, query))


def searchsorted(t: np.ndarray, query) -> int:
    """First index with ``t[i] >= query`` (numpy's ``side='left'``)."""
    lib = _load()
    if lib is None or not t.flags.c_contiguous:
        return searchsorted_plain(t, query)
    if t.dtype == np.int32:
        return int(lib.ebt_searchsorted_i32(_ptr(t, ctypes.c_int32), len(t),
                                            int(query)))
    if t.dtype == np.float64:
        return int(lib.ebt_searchsorted_f64(_ptr(t, ctypes.c_double), len(t),
                                            float(query)))
    return searchsorted_plain(t, query)


# ---------------------------------------------------------------------------
# Padded window extraction
# ---------------------------------------------------------------------------

def window_padded_plain(x, y, t, p, i0: int, i1: int, capacity: int):
    out = [np.zeros(capacity, np.float32) for _ in range(4)]
    valid = np.zeros(capacity, np.uint8)
    n = min(i1 - i0, capacity)
    out[0][:n] = y[i0:i0 + n]
    out[1][:n] = x[i0:i0 + n]
    out[2][:n] = t[i0:i0 + n] * 1e-6
    out[3][:n] = p[i0:i0 + n]
    valid[:n] = 1
    return (*out, valid, int(n))


def window_padded(x: np.ndarray, y: np.ndarray, t: np.ndarray, p: np.ndarray,
                  i0: int, i1: int, capacity: int):
    """Events ``[i0, i1)`` of the raw stream (sensor x = width, int16; y;
    int32 µs; uint8 polarity) as padded float32 fields: row = sensor y,
    column = sensor x, seconds.  Returns ``(x, y, t, p, valid, n_live)``.
    The native route scales the time in float32, the plain one in
    float64."""
    if not (len(x) == len(y) == len(t) == len(p)
            and 0 <= i0 <= i1 <= len(x) and capacity >= 0):
        raise ValueError(f"window [{i0}, {i1}) of {len(x)} events, "
                         f"capacity {capacity}")
    x, y, t, p = (np.ascontiguousarray(a) for a in (x, y, t, p))
    lib = _load()
    if (lib is None or x.dtype != np.int16 or y.dtype != np.int16
            or t.dtype != np.int32 or p.dtype != np.uint8):
        return window_padded_plain(x, y, t, p, i0, i1, capacity)
    out = [np.empty(capacity, np.float32) for _ in range(4)]
    valid = np.empty(capacity, np.uint8)
    n = lib.ebt_window_padded(
        _ptr(x, ctypes.c_int16), _ptr(y, ctypes.c_int16),
        _ptr(t, ctypes.c_int32), _ptr(p, ctypes.c_uint8),
        int(i0), int(i1), int(capacity),
        _ptr(out[0], ctypes.c_float), _ptr(out[1], ctypes.c_float),
        _ptr(out[2], ctypes.c_float), _ptr(out[3], ctypes.c_float),
        _ptr(valid, ctypes.c_uint8))
    return (*out, valid, int(n))


# ---------------------------------------------------------------------------
# Background-activity and hot-pixel filters
# ---------------------------------------------------------------------------

def baf_filter_plain(events: np.ndarray, image_shape: Tuple[int, int],
                     dt: float, ksize: int = 1, num_support: int = 1,
                     time_map: Optional[np.ndarray] = None):
    h, w = image_shape
    ev = np.ascontiguousarray(events, np.float64)
    if time_map is None:
        time_map = np.zeros((h, w), np.float64)
    keep = np.empty(len(ev), np.uint8)
    for i, e in enumerate(ev):
        x = min(max(int(e[0]), 0), h - 1)
        y = min(max(int(e[1]), 0), w - 1)
        ts = e[2]
        time_map[x, y] = max(time_map[x, y], ts)
        win = time_map[max(0, x - ksize):min(h, x + ksize + 1),
                       max(0, y - ksize):min(w, y + ksize + 1)].ravel()
        k = min(num_support, win.size - 1)
        last = np.partition(win, win.size - 1 - k)[win.size - 1 - k]
        keep[i] = (ts - last) < dt
    return keep.astype(bool), time_map


def baf_filter(events: np.ndarray, image_shape: Tuple[int, int], dt: float,
               ksize: int = 1, num_support: int = 1,
               time_map: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The exact sequential background-activity filter over ``(n, 4)``
    events ``(row, col, t s, p)``: each event writes its time into the
    per-pixel latest-time map and is kept iff the ``num_support + 1``-th
    most recent time in its ``(2k+1)²`` neighbourhood is younger than
    ``dt``.  ``time_map`` (float64 ``H×W``) is updated in place and carried
    across calls for the continuous variant.  Returns ``(keep, time_map)``.
    """
    lib = _load()
    if lib is None:
        return baf_filter_plain(events, image_shape, dt, ksize, num_support,
                                time_map)
    h, w = image_shape
    ev = np.ascontiguousarray(events, np.float64)
    if time_map is None:
        time_map = np.zeros((h, w), np.float64)
    if (ev.ndim != 2 or ev.shape[1] != 4 or time_map.shape != (h, w)
            or time_map.dtype != np.float64
            or not time_map.flags.c_contiguous):
        raise ValueError("baf_filter needs (n, 4) events and a C-contiguous "
                         f"float64 {h}x{w} time map")
    keep = np.empty(len(ev), np.uint8)
    lib.ebt_baf_filter(_ptr(ev, ctypes.c_double), len(ev), h, w, float(dt),
                       int(ksize), int(num_support),
                       _ptr(time_map, ctypes.c_double),
                       _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool), time_map


def hot_pixel_filter_plain(events: np.ndarray, image_shape: Tuple[int, int],
                           thresh: float) -> np.ndarray:
    """Plain version of :func:`hot_pixel_filter` (it clamps out-of-frame
    events to the edge pixels, where the native route keeps them)."""
    h, w = image_shape
    ev = np.ascontiguousarray(events, np.float64)
    xi = np.clip(ev[:, 0].astype(int), 0, h - 1)
    yi = np.clip(ev[:, 1].astype(int), 0, w - 1)
    count = np.zeros((h, w), np.int64)
    np.add.at(count, (xi, yi), 1)
    return count[xi, yi] <= thresh


def hot_pixel_filter(events: np.ndarray, image_shape: Tuple[int, int],
                     thresh: float) -> np.ndarray:
    """Keep mask of the events on pixels with at most ``thresh`` events."""
    lib = _load()
    if lib is None:
        return hot_pixel_filter_plain(events, image_shape, thresh)
    h, w = image_shape
    ev = np.ascontiguousarray(events, np.float64)
    if ev.ndim != 2 or ev.shape[1] != 4:
        raise ValueError("hot_pixel_filter needs (n, 4) events")
    count = np.zeros((h, w), np.int32)
    keep = np.empty(len(ev), np.uint8)
    lib.ebt_hot_pixel_filter(_ptr(ev, ctypes.c_double), len(ev), h, w,
                             float(thresh), _ptr(count, ctypes.c_int32),
                             _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)


# ---------------------------------------------------------------------------
# Prophesee EVT3 decoding
# ---------------------------------------------------------------------------

def _evt3_words(raw: bytes) -> np.ndarray:
    """The 16-bit words after the ASCII header (lines starting with
    ``%``); an odd byte before the words is skipped."""
    offset = 0
    while raw[offset:offset + 1] == b"%":
        offset = raw.index(b"\n", offset) + 1
    if (len(raw) - offset) % 2:
        return np.frombuffer(raw[offset + 1:], np.uint16)
    return np.frombuffer(raw, np.uint16, offset=offset)


def decode_evt3_plain(raw: bytes) -> dict:
    """Python-loop version of :func:`decode_evt3`: the same words, the
    same events."""
    xs, ys, ts, ps = [], [], [], []
    high = low = 0
    have_high = False
    cur_y = base_x = pol = 0
    for wrd in _evt3_words(raw).tolist():
        typ = wrd >> 12
        if typ == 0x0:
            cur_y = wrd & 0x7FF
        elif typ == 0x2:
            pol = (wrd >> 11) & 1
            xs.append(wrd & 0x7FF)
            ys.append(cur_y)
            ts.append((high << 12) | low)
            ps.append(pol)
        elif typ == 0x3:
            base_x = wrd & 0x7FF
            pol = (wrd >> 11) & 1
        elif typ in (0x4, 0x5):
            bits = 12 if typ == 0x4 else 8
            for b in range(bits):
                if wrd & (1 << b):
                    xs.append(base_x + b)
                    ys.append(cur_y)
                    ts.append((high << 12) | low)
                    ps.append(pol)
            base_x += bits
        elif typ == 0x6:
            low = wrd & 0xFFF
        elif typ == 0x8:
            th = wrd & 0xFFF
            if have_high and th < (high & 0xFFF):
                high = ((high >> 12) + 1) << 12 | th  # the 12-bit wrap
            else:
                high = (high & ~0xFFF) | th
            have_high = True
    return {"x": np.asarray(xs, np.int16), "y": np.asarray(ys, np.int16),
            "t": np.asarray(ts, np.int64).astype(np.int32),
            "p": np.asarray(ps, np.uint8).astype(bool)}


def decode_evt3(raw: bytes, capacity: Optional[int] = None) -> dict:
    """Decode a Prophesee EVT3 ``.raw`` payload into the HDF5 layout:
    ``x`` (sensor column), ``y`` (sensor row) int16, ``t`` int32 µs, ``p``
    bool.  At most ``capacity`` events (default: 12 a word, the most the
    words can hold)."""
    lib = _load()
    if lib is None:
        out = decode_evt3_plain(raw)
        return out if capacity is None else {k: v[:capacity]
                                             for k, v in out.items()}
    words = np.ascontiguousarray(_evt3_words(raw))
    cap = capacity or len(words) * 12
    out_x = np.empty(cap, np.int16)
    out_y = np.empty(cap, np.int16)
    out_t = np.empty(cap, np.int32)
    out_p = np.empty(cap, np.uint8)
    n = lib.ebt_decode_evt3(_ptr(words, ctypes.c_uint16), len(words), cap,
                            _ptr(out_x, ctypes.c_int16),
                            _ptr(out_y, ctypes.c_int16),
                            _ptr(out_t, ctypes.c_int32),
                            _ptr(out_p, ctypes.c_uint8))
    return {"x": out_x[:n], "y": out_y[:n], "t": out_t[:n],
            "p": out_p[:n].astype(bool)}
