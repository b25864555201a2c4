"""ctypes bindings for native/bn254_curve.cpp — BN254 G1/G2 Pippenger MSM
and fixed-base batches for the in-house Groth16 prover (snark/groth16.py).

Points cross the FFI as canonical LE u64 limbs; infinity as a flag word.
Differential-tested against verifier/bn254_pairing.py's pure-python curve
in tests/test_circuit_dsl.py + tests/test_groth16.py. Callers must check
`available()`.
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
        if os.environ.get("ZIREN_NO_NATIVE_CURVE") == "1":
            return None
        so = os.path.join(_NATIVE_DIR, "libziren_bn254_curve.so")
        src = os.path.join(_NATIVE_DIR, "bn254_curve.cpp")
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                subprocess.check_call(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", so, src,
                     "-lpthread"]
                )
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError):
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        for name in ("bn254_g1_msm", "bn254_g1_fixed", "bn254_g2_msm",
                     "bn254_g2_fixed"):
            getattr(lib, name).argtypes = [u64p, u64p, ctypes.c_uint64, u64p]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


_NTT_LIB = None
_NTT_TRIED = False


def _load_ntt():
    global _NTT_LIB, _NTT_TRIED
    if _NTT_TRIED:
        return _NTT_LIB
    with _LOCK:
        if _NTT_TRIED:
            return _NTT_LIB
        _NTT_TRIED = True
        if os.environ.get("ZIREN_NO_NATIVE_CURVE") == "1":
            return None
        so = os.path.join(_NATIVE_DIR, "libziren_bn254_ntt.so")
        src = os.path.join(_NATIVE_DIR, "bn254_ntt.cpp")
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                subprocess.check_call(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", so, src,
                     "-lpthread"]
                )
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError):
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.bn254_ntt.argtypes = [u64p, ctypes.c_uint64, u64p,
                                  ctypes.c_int, u64p]
        _NTT_LIB = lib
    return _NTT_LIB


def ntt_available() -> bool:
    return _load_ntt() is not None


def ntt(vals, root: int, invert: bool, n_inv: int) -> list:
    """In-place-semantics NTT over Fr: vals canonical ints, root the
    forward primitive n-th root (pass its inverse + n_inv for invert)."""
    lib = _load_ntt()
    n = len(vals)
    buf = b"".join(int(x).to_bytes(32, "little") for x in vals)
    arr = np.frombuffer(buf, dtype=np.uint64).reshape(n, 4).copy()
    r = _limbs([root], 4)[0].copy()
    ni = _limbs([n_inv], 4)[0].copy()
    lib.bn254_ntt(_ptr(arr), n,
                  r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                  1 if invert else 0,
                  ni.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    flat = arr.tobytes()
    return [int.from_bytes(flat[32 * i: 32 * i + 32], "little")
            for i in range(n)]


def _limbs(vals, width: int) -> np.ndarray:
    out = np.zeros((len(vals), width), dtype=np.uint64)
    for i, v in enumerate(vals):
        v = int(v)
        for j in range(width):
            out[i, j] = v & 0xFFFFFFFFFFFFFFFF
            v >>= 64
    return out


def _unlimb(arr) -> int:
    acc = 0
    for x in reversed(list(arr)):
        acc = (acc << 64) | int(x)
    return acc


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def g1_msm(points, scalars):
    """points: [(x, y) ints] (no infinities), scalars: ints. Returns (x, y)
    or None for the infinity result."""
    lib = _load()
    n = len(points)
    pts = np.zeros((n, 8), dtype=np.uint64)
    pts[:, :4] = _limbs([p[0] for p in points], 4)
    pts[:, 4:] = _limbs([p[1] for p in points], 4)
    sc = _limbs(scalars, 4)
    out = np.zeros(9, dtype=np.uint64)
    lib.bn254_g1_msm(_ptr(pts), _ptr(sc), n, _ptr(out))
    if out[8]:
        return None
    return (_unlimb(out[:4]), _unlimb(out[4:8]))


def g1_fixed(base, scalars):
    """Many scalars on one G1 base. Returns [(x, y) | None]."""
    lib = _load()
    n = len(scalars)
    b = np.concatenate([_limbs([base[0]], 4)[0], _limbs([base[1]], 4)[0]])
    sc = _limbs(scalars, 4)
    out = np.zeros((n, 9), dtype=np.uint64)
    lib.bn254_g1_fixed(_ptr(b), _ptr(sc), n, _ptr(out))
    return [
        None if out[i, 8] else (_unlimb(out[i, :4]), _unlimb(out[i, 4:8]))
        for i in range(n)
    ]


def _g2_flat(p):
    """((x0, x1) FQ2, (y0, y1) FQ2) -> 16 limbs; accepts FQ2 objects with
    .coeffs or plain pairs."""
    x, y = p
    x = getattr(x, "c", x)
    y = getattr(y, "c", y)
    return [int(x[0]), int(x[1]), int(y[0]), int(y[1])]


def g2_msm(points, scalars):
    """points: [((x0,x1),(y0,y1))]. Returns ((x0,x1),(y0,y1)) or None."""
    lib = _load()
    n = len(points)
    flat = [_g2_flat(p) for p in points]
    pts = np.zeros((n, 16), dtype=np.uint64)
    for i, (x0, x1, y0, y1) in enumerate(flat):
        pts[i, 0:4] = _limbs([x0], 4)[0]
        pts[i, 4:8] = _limbs([x1], 4)[0]
        pts[i, 8:12] = _limbs([y0], 4)[0]
        pts[i, 12:16] = _limbs([y1], 4)[0]
    sc = _limbs(scalars, 4)
    out = np.zeros(17, dtype=np.uint64)
    lib.bn254_g2_msm(_ptr(pts), _ptr(sc), n, _ptr(out))
    if out[16]:
        return None
    return (
        (_unlimb(out[0:4]), _unlimb(out[4:8])),
        (_unlimb(out[8:12]), _unlimb(out[12:16])),
    )


def g2_fixed(base, scalars):
    lib = _load()
    n = len(scalars)
    x0, x1, y0, y1 = _g2_flat(base)
    b = np.zeros(16, dtype=np.uint64)
    b[0:4] = _limbs([x0], 4)[0]
    b[4:8] = _limbs([x1], 4)[0]
    b[8:12] = _limbs([y0], 4)[0]
    b[12:16] = _limbs([y1], 4)[0]
    sc = _limbs(scalars, 4)
    out = np.zeros((n, 17), dtype=np.uint64)
    lib.bn254_g2_fixed(_ptr(b), _ptr(sc), n, _ptr(out))
    res = []
    for i in range(n):
        if out[i, 16]:
            res.append(None)
        else:
            res.append((
                (_unlimb(out[i, 0:4]), _unlimb(out[i, 4:8])),
                (_unlimb(out[i, 8:12]), _unlimb(out[i, 12:16])),
            ))
    return res
