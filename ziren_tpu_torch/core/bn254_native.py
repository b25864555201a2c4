"""ctypes bindings for native/bn254_p2.cpp — multithreaded Poseidon2-BN254.

Fast path for the outer (wrap) config's Merkle hashing and challenger
permutation; bit-identical to core/bn254.py (differential-tested in
tests/test_bn254.py). Callers must check `available()`.
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
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("ZIREN_NO_NATIVE_HASH") == "1":
            return None
        so = os.path.join(_NATIVE_DIR, "libziren_bn254.so")
        src = os.path.join(_NATIVE_DIR, "bn254_p2.cpp")
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                subprocess.check_call(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", so, src,
                     "-lpthread"]
                )
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError):
            return None
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.bn254_hash_rows.argtypes = [u32p, ctypes.c_uint64,
                                        ctypes.c_uint32, u64p]
        lib.bn254_compress_pairs.argtypes = [u64p, ctypes.c_uint64, u64p]
        lib.bn254_permute_batch.argtypes = [u64p, ctypes.c_uint64]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _to_limbs(vals) -> np.ndarray:
    """list of Fr ints -> (n, 4) uint64 LE limb array."""
    out = np.zeros((len(vals), 4), dtype=np.uint64)
    for i, v in enumerate(vals):
        v = int(v)
        for j in range(4):
            out[i, j] = v & 0xFFFFFFFFFFFFFFFF
            v >>= 64
    return out


def _from_limbs(arr: np.ndarray) -> list:
    arr = np.asarray(arr, dtype=np.uint64)
    return [
        int(arr[i, 0])
        | (int(arr[i, 1]) << 64)
        | (int(arr[i, 2]) << 128)
        | (int(arr[i, 3]) << 192)
        for i in range(arr.shape[0])
    ]


def hash_rows(rows: np.ndarray) -> list:
    """(n, w) uint32 KoalaBear rows -> n Fr digests (python ints)."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    n, w = rows.shape
    out = np.zeros((n, 4), dtype=np.uint64)
    lib.bn254_hash_rows(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return _from_limbs(out)


def compress_pairs(digests: list) -> list:
    """2n Fr digests -> n compressed digests."""
    lib = _load()
    arr = np.ascontiguousarray(_to_limbs(digests))
    n = len(digests) // 2
    out = np.zeros((n, 4), dtype=np.uint64)
    lib.bn254_compress_pairs(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return _from_limbs(out)


def permute_batch(states: np.ndarray) -> np.ndarray:
    """(n, 3, 4) uint64 canonical limb states, permuted in place-copy."""
    lib = _load()
    arr = np.ascontiguousarray(states, dtype=np.uint64)
    lib.bn254_permute_batch(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        arr.shape[0],
    )
    return arr
