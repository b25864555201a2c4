"""ctypes binding of csrc/septic_sum.cpp: the running sum of the Global
chip's trace (machine/global_chip.py) in one native call over all rows.

The library is built with g++ into ziren_tpu_torch/_build/ on first use,
and again whenever the source is newer than it. Where it cannot be built or
loaded, `available()` is False and the chip adds its points in Python
(`global_chip._running_sums`, which the tests hold this against).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from . import septic as S

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "septic_sum.cpp")
_LIB_PATH = os.path.join(_PKG, "_build", "libzt_septic_sum.so")
_LOCK = threading.Lock()
_STATE: list = []  # [(library or None, the Frobenius matrices)] once tried


def _build() -> None:
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
        return
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"  # processes building at once
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                   check=True, capture_output=True)
    os.replace(tmp, _LIB_PATH)


def _load():
    with _LOCK:
        if not _STATE:
            try:
                _build()
                lib = ctypes.CDLL(_LIB_PATH)
            except (OSError, subprocess.CalledProcessError):
                lib = None
            if lib is not None:
                u32p = ctypes.POINTER(ctypes.c_uint32)
                lib.zt_septic_running_sums.argtypes = [u32p, u32p, u32p, ctypes.c_uint64,
                                                       u32p, u32p, u32p]
                lib.zt_septic_running_sums.restype = None
            S.frobenius(S.sone(), 1)  # builds S._FROB_MATS once
            frob = np.ascontiguousarray(np.stack([S._FROB_MATS[1], S._FROB_MATS[2]]),
                                        dtype=np.uint32)
            _STATE.append((lib, frob))
        return _STATE[0]


def available() -> bool:
    return _load()[0] is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def running_sums(start, xs, ys):
    """`global_chip._running_sums` in one native call: the slopes and
    running sums of adding the points (xs[i], ys[i]), in order, to `start`.
    Returns ((n, 7) slopes, (n, 14) sums: x then y)."""
    lib, frob = _load()
    s = np.ascontiguousarray(np.concatenate([start[0], start[1]]), dtype=np.uint32)
    xs = np.ascontiguousarray(xs, dtype=np.uint32).reshape(-1, 7)
    ys = np.ascontiguousarray(ys, dtype=np.uint32).reshape(-1, 7)
    n = xs.shape[0]
    if s.shape != (14,) or ys.shape != xs.shape:
        raise ValueError(f"running_sums: start {s.shape}, xs {xs.shape}, ys {ys.shape}")
    slopes = np.zeros((n, 7), dtype=np.uint32)
    sums = np.zeros((n, 14), dtype=np.uint32)
    lib.zt_septic_running_sums(_ptr(s), _ptr(xs), _ptr(ys), n, _ptr(frob), _ptr(slopes),
                               _ptr(sums))
    return slopes, sums
