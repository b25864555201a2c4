"""FrVec — BN254 scalar-field vectors backed by native kernels.

The SNARK layer's pointwise passes (Plonk quotient/grand-product/fold,
Groth16 coset combine — snark/plonk.py, snark/groth16.py) are O(n) over
domains of 2^22..2^25 elements at wrap scale; in pure python each pass is
minutes-to-hours. FrVec keeps a vector as a numpy (n, 4) uint64 limb array
(canonical form) and runs add/sub/mul/scale/powers/batch-inv/Horner/
synthetic-division/NTT through native/bn254_ntt.cpp's threaded C kernels,
converting to python ints only at protocol boundaries (transcript bytes,
MSM scalars).

Reference analogue: gnark's backend/plonk runs on gnark-crypto's field
vectors; this is that layer for the in-house provers. Falls back to pure
python (via int lists) when the native library is unavailable
(ZIREN_NO_NATIVE_CURVE=1), so every caller stays correct everywhere.
"""

from __future__ import annotations

import ctypes

import numpy as np

# BN254 scalar field modulus (Fr) and its multiplicative generator.
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
_GEN = 5

_U64P = ctypes.POINTER(ctypes.c_uint64)
_SIGS_SET = False


def _lib():
    """The shared bn254_ntt library, with the vector-kernel signatures
    registered once. None when native is unavailable."""
    global _SIGS_SET
    from . import bn254_curve_native as bcn

    lib = bcn._load_ntt()
    if lib is None:
        return None
    if not _SIGS_SET:
        lib.bn254_fr_vec_op.argtypes = [_U64P, _U64P, ctypes.c_uint64,
                                        ctypes.c_int, _U64P]
        lib.bn254_fr_vec_scale.argtypes = [_U64P, _U64P, ctypes.c_uint64, _U64P]
        lib.bn254_fr_vec_axpy.argtypes = [_U64P, _U64P, _U64P, ctypes.c_uint64]
        lib.bn254_fr_powers.argtypes = [_U64P, _U64P, ctypes.c_uint64, _U64P]
        lib.bn254_fr_horner.argtypes = [_U64P, ctypes.c_uint64, _U64P, _U64P]
        lib.bn254_fr_div_linear.argtypes = [_U64P, ctypes.c_uint64, _U64P, _U64P]
        lib.bn254_fr_batch_inv.argtypes = [_U64P, ctypes.c_uint64, _U64P]
        lib.bn254_fr_prefix_mul.argtypes = [_U64P, ctypes.c_uint64, _U64P]
        _SIGS_SET = True
    return lib


def available() -> bool:
    return _lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _scalar_limbs(v: int) -> np.ndarray:
    return np.frombuffer(int(v % R).to_bytes(32, "little"),
                         dtype=np.uint64).copy()


def _root_of_unity(log_n: int) -> int:
    return pow(_GEN, (R - 1) >> log_n, R)


class FrVec:
    """A canonical-form Fr vector: numpy (n, 4) uint64 LE limbs."""

    __slots__ = ("a",)

    def __init__(self, arr: np.ndarray):
        assert arr.ndim == 2 and arr.shape[1] == 4 and arr.dtype == np.uint64
        self.a = np.ascontiguousarray(arr)

    # -- conversions ------------------------------------------------------

    @classmethod
    def from_ints(cls, vals) -> "FrVec":
        buf = b"".join((int(v) % R).to_bytes(32, "little") for v in vals)
        n = len(vals)
        return cls(np.frombuffer(buf, dtype=np.uint64).reshape(n, 4).copy())

    def to_ints(self) -> list:
        flat = self.a.tobytes()
        return [int.from_bytes(flat[32 * i: 32 * i + 32], "little")
                for i in range(len(self))]

    def __len__(self) -> int:
        return self.a.shape[0]

    def copy(self) -> "FrVec":
        return FrVec(self.a.copy())

    def slice(self, lo: int, hi: int) -> "FrVec":
        return FrVec(self.a[lo:hi].copy())

    @classmethod
    def zeros(cls, n: int) -> "FrVec":
        return cls(np.zeros((n, 4), dtype=np.uint64))

    def pad(self, n: int) -> "FrVec":
        """Zero-pad (or truncate) to length n."""
        m = len(self)
        if m == n:
            return self
        if m > n:
            return self.slice(0, n)
        out = np.zeros((n, 4), dtype=np.uint64)
        out[:m] = self.a
        return FrVec(out)

    def item(self, i: int) -> int:
        return int.from_bytes(self.a[i].tobytes(), "little")

    # -- elementwise ------------------------------------------------------

    def _binop(self, other: "FrVec", op: int) -> "FrVec":
        assert len(self) == len(other)
        lib = _lib()
        if lib is None:
            xs, ys = self.to_ints(), other.to_ints()
            f = [lambda x, y: (x + y) % R, lambda x, y: (x - y) % R,
                 lambda x, y: x * y % R][op]
            return FrVec.from_ints([f(x, y) for x, y in zip(xs, ys)])
        out = np.empty_like(self.a)
        lib.bn254_fr_vec_op(_ptr(self.a), _ptr(other.a), len(self), op,
                            _ptr(out))
        return FrVec(out)

    def __add__(self, other: "FrVec") -> "FrVec":
        return self._binop(other, 0)

    def __sub__(self, other: "FrVec") -> "FrVec":
        return self._binop(other, 1)

    def __mul__(self, other: "FrVec") -> "FrVec":
        return self._binop(other, 2)

    def scale(self, s: int) -> "FrVec":
        lib = _lib()
        if lib is None:
            s %= R
            return FrVec.from_ints([x * s % R for x in self.to_ints()])
        out = np.empty_like(self.a)
        sv = _scalar_limbs(s)
        lib.bn254_fr_vec_scale(_ptr(self.a), _ptr(sv), len(self), _ptr(out))
        return FrVec(out)

    def axpy_(self, s: int, c: "FrVec") -> None:
        """self[:m] += s * c in place (c may be shorter than self)."""
        m = len(c)
        assert m <= len(self)
        lib = _lib()
        if lib is None:
            s %= R
            xs = self.to_ints()
            for k, v in enumerate(c.to_ints()):
                xs[k] = (xs[k] + s * v) % R
            self.a = FrVec.from_ints(xs).a
            return
        sv = _scalar_limbs(s)
        lib.bn254_fr_vec_axpy(_ptr(self.a), _ptr(sv), _ptr(c.a), m)

    # -- sequences & polynomials -----------------------------------------

    @classmethod
    def powers(cls, base: int, n: int, start: int = 1) -> "FrVec":
        """[start, start*base, start*base^2, ...] of length n."""
        lib = _lib()
        if lib is None:
            base %= R
            out, cur = [], start % R
            for _ in range(n):
                out.append(cur)
                cur = cur * base % R
            return cls.from_ints(out)
        out = np.empty((n, 4), dtype=np.uint64)
        bv, sv = _scalar_limbs(base), _scalar_limbs(start)
        lib.bn254_fr_powers(_ptr(bv), _ptr(sv), n, _ptr(out))
        return cls(out)

    def horner(self, x: int) -> int:
        """Evaluate self as poly coefficients (index 0 = constant) at x."""
        lib = _lib()
        if lib is None:
            acc = 0
            for c in reversed(self.to_ints()):
                acc = (acc * x + c) % R
            return acc
        out = np.zeros(4, dtype=np.uint64)
        xv = _scalar_limbs(x)
        lib.bn254_fr_horner(_ptr(self.a), len(self), _ptr(xv), _ptr(out))
        return int.from_bytes(out.tobytes(), "little")

    def div_linear(self, x0: int) -> "FrVec":
        """(p(X) - p(x0)) / (X - x0) by synthetic division."""
        n = len(self)
        lib = _lib()
        if lib is None:
            cs = self.to_ints()
            out = [0] * (n - 1)
            acc = 0
            for k in range(n - 1, 0, -1):
                acc = (acc * x0 + cs[k]) % R
                out[k - 1] = acc
            return FrVec.from_ints(out)
        out = np.empty((n - 1, 4), dtype=np.uint64)
        xv = _scalar_limbs(x0)
        lib.bn254_fr_div_linear(_ptr(self.a), n, _ptr(xv), _ptr(out))
        return FrVec(out)

    @classmethod
    def batch_inv(cls, v: "FrVec") -> "FrVec":
        """Elementwise inverse, 0 -> 0 (Montgomery trick)."""
        lib = _lib()
        if lib is None:
            return cls.from_ints([pow(x, R - 2, R) if x else 0
                                  for x in v.to_ints()])
        out = np.empty_like(v.a)
        lib.bn254_fr_batch_inv(_ptr(v.a), len(v), _ptr(out))
        return cls(out)

    def add_scalar(self, s: int) -> "FrVec":
        """self + s (broadcast)."""
        return self + FrVec.powers(1, len(self), start=s)

    @classmethod
    def prefix_mul(cls, v: "FrVec") -> "FrVec":
        """out[0] = 1, out[i] = v[0] * ... * v[i-1] (grand product)."""
        lib = _lib()
        if lib is None:
            xs = v.to_ints()
            out, run = [], 1
            for x in xs:
                out.append(run)
                run = run * x % R
            return cls.from_ints(out)
        out = np.empty_like(v.a)
        lib.bn254_fr_prefix_mul(_ptr(v.a), len(v), _ptr(out))
        return cls(out)

    # -- NTT ---------------------------------------------------------------

    def ntt(self, invert: bool = False) -> "FrVec":
        """Radix-2 NTT over the standard 2^k domain (root from gen 5),
        in the same orientation as snark/groth16._ntt."""
        n = len(self)
        assert n & (n - 1) == 0 and n >= 2
        lib = _lib()
        if lib is None:
            from .groth16 import _ntt
            return FrVec.from_ints(_ntt(self.to_ints(), invert=invert))
        root = _root_of_unity(n.bit_length() - 1)
        arr = self.a.copy()
        if invert:
            rv = _scalar_limbs(pow(root, R - 2, R))
            ni = _scalar_limbs(pow(n, R - 2, R))
        else:
            rv = _scalar_limbs(root)
            ni = _scalar_limbs(1)
        lib.bn254_ntt(_ptr(arr), n, _ptr(rv), 1 if invert else 0, _ptr(ni))
        return FrVec(arr)
