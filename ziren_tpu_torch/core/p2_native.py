"""ctypes bindings for native/hashing.cpp — multithreaded batched Poseidon2.

Drop-in fast path for the host prover's Merkle hashing (core/merkle.py) and
challenger grinding; bit-identical to core/poseidon2.py (differentially
tested in tests/test_poseidon2.py). Falls back silently if the toolchain is
unavailable: callers must check `available()`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_TRIED = False
_LOCK = threading.Lock()
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        return _load_locked()


def _load_locked():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("ZIREN_NO_NATIVE_HASH") == "1":
        return None
    so = os.path.join(_NATIVE_DIR, "libziren_hashing.so")
    src = os.path.join(_NATIVE_DIR, "hashing.cpp")
    try:
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            subprocess.check_call(
                ["g++", "-O3", "-shared", "-fPIC", "-o", so, src, "-lpthread"]
            )
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError):
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.ziren_p2_hash_rows.argtypes = [u32p, ctypes.c_uint64, ctypes.c_uint32, u32p]
    lib.ziren_p2_compress.argtypes = [u32p, u32p, ctypes.c_uint64, u32p]
    lib.ziren_p2_compress_pairs.argtypes = [u32p, ctypes.c_uint64, u32p]
    lib.ziren_p2_permute.argtypes = [u32p, ctypes.c_uint64]
    lib.ziren_ntt.argtypes = [
        u32p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.ziren_septic_lift_x.argtypes = [u32p, ctypes.c_uint64, u32p, u32p, u32p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def hash_rows(rows: np.ndarray) -> np.ndarray:
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    n, w = rows.shape
    out = np.empty((n, 8), dtype=np.uint32)
    lib.ziren_p2_hash_rows(_ptr(rows), n, w, _ptr(out))
    return out


def compress(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    lib = _load()
    left = np.ascontiguousarray(left, dtype=np.uint32).reshape(-1, 8)
    right = np.ascontiguousarray(right, dtype=np.uint32).reshape(-1, 8)
    n = left.shape[0]
    out = np.empty((n, 8), dtype=np.uint32)
    lib.ziren_p2_compress(_ptr(left), _ptr(right), n, _ptr(out))
    return out


def ntt_bitrev(data: np.ndarray, root: int, post_scale: int = 1) -> np.ndarray:
    """In-place butterflies on pre-bit-reversed (n, w) canonical uint32."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.uint32)
    n, w = data.shape
    lib.ziren_ntt(_ptr(data), n, w, root % 2130706433, post_scale % 2130706433)
    return data


def septic_lift_x(msgs: np.ndarray):
    """Hash-to-curve for (n, 7) messages -> (xs (n,7), ys (n,7), offsets (n,))."""
    lib = _load()
    msgs = np.ascontiguousarray(msgs, dtype=np.uint32).reshape(-1, 7)
    n = msgs.shape[0]
    xs = np.empty((n, 7), dtype=np.uint32)
    ys = np.empty((n, 7), dtype=np.uint32)
    offs = np.empty(n, dtype=np.uint32)
    lib.ziren_septic_lift_x(_ptr(msgs), n, _ptr(xs), _ptr(ys), _ptr(offs))
    if np.any(offs == 0xFFFFFFFF):
        raise ValueError("curve point not found after 256 offsets")
    return xs, ys, offs


def permute(states: np.ndarray) -> np.ndarray:
    lib = _load()
    out = np.ascontiguousarray(states, dtype=np.uint32).copy()
    flat = out.reshape(-1, 16)
    lib.ziren_p2_permute(_ptr(flat), flat.shape[0])
    return out
