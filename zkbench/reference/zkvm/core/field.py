"""KoalaBear prime field arithmetic (host path, numpy).

The framework's base field is KoalaBear, p = 2^31 - 2^24 + 1, matching the
reference zkVM's Plonky3 backend (reference: crates/stark/src/kb31_poseidon2.rs,
crates/primitives/src/lib.rs). Elements are stored as canonical uint32 numpy
arrays on the host; the device (TPU) path in `ziren_tpu.ops.jfield` uses a
Montgomery representation with R = 2^32.

Conventions pinned to Plonky3:
  * multiplicative generator g = 3
  * two-adicity 24; two_adic_generator(k) = (3^127)^(2^(24-k)) mod p
    (3^127 = 0x6ac49f88 matches Plonky3's KoalaBear table)
  * degree-4 binomial extension x^4 = 3 (verified against the gnark circuit,
    reference: crates/recursion/gnark-ffi/go/zkm/koalabear/koalabear.go MulE)
"""

from __future__ import annotations

import numpy as np

P = np.uint32(2130706433)  # 2^31 - 2^24 + 1
P_INT = 2130706433
TWO_ADICITY = 24
GENERATOR = 3  # multiplicative generator of F_p^*
# Montgomery constants (device representation; R = 2^32)
MONTY_MU = 2130706431  # -p^{-1} mod 2^32
MONTY_R = 33554430  # 2^32 mod p     (Montgomery form of 1)
MONTY_R2 = 402124772  # 2^64 mod p   (for encoding)

_G24 = pow(GENERATOR, 127, P_INT)  # order-2^24 root of unity


def two_adic_generator(bits: int) -> int:
    """Canonical 2^bits-th root of unity (Plonky3 convention)."""
    assert 0 <= bits <= TWO_ADICITY
    return pow(_G24, 1 << (TWO_ADICITY - bits), P_INT)


# ---------------------------------------------------------------------------
# numpy vectorized ops on canonical uint32 arrays
# ---------------------------------------------------------------------------


def fadd(a, b):
    """a + b mod p, elementwise on uint32 arrays."""
    with np.errstate(over="ignore"):
        s = np.add(a, b, dtype=np.uint32)  # < 2^32 since a,b < 2^31
        return np.where(s >= P, s - P, s).astype(np.uint32)


def fsub(a, b):
    with np.errstate(over="ignore"):
        d = np.subtract(a, b, dtype=np.uint32)
        # if a < b the subtraction wrapped; add p back
        return np.where(
            np.asarray(a, dtype=np.uint32) < np.asarray(b, dtype=np.uint32), d + P, d
        ).astype(np.uint32)


def fneg(a):
    a = np.asarray(a, dtype=np.uint32)
    return np.where(a == 0, a, P - a).astype(np.uint32)


def fmul(a, b):
    t = np.asarray(a, dtype=np.uint64) * np.asarray(b, dtype=np.uint64)
    return (t % np.uint64(P_INT)).astype(np.uint32)


def fpow(a, e: int):
    """a ** e (scalar integer exponent), elementwise."""
    result = np.ones_like(np.asarray(a, dtype=np.uint32))
    base = np.asarray(a, dtype=np.uint32)
    while e > 0:
        if e & 1:
            result = fmul(result, base)
        base = fmul(base, base)
        e >>= 1
    return result


def finv(a):
    return fpow(a, P_INT - 2)


def fsum(a, axis=None):
    """Sum of field elements along an axis."""
    t = np.sum(np.asarray(a, dtype=np.uint64), axis=axis, dtype=np.uint64)
    return (t % np.uint64(P_INT)).astype(np.uint32)


def from_int(x) -> np.uint32:
    return np.uint32(int(x) % P_INT)


def from_wrapped_u32(x) -> np.uint32:
    """Plonky3 from_wrapped_u32: reduce an arbitrary u32 mod p."""
    return np.uint32(int(x) % P_INT)


_POWERS_CACHE: dict = {}


def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] as uint32. Cached per base and
    grown by doubling (hot in LDE shifts and reduced openings)."""
    key = int(base) % P_INT
    cached = _POWERS_CACHE.get(key)
    if cached is None or cached.shape[0] < n:
        m = max(16, 1 << (max(n, 1) - 1).bit_length())
        out = np.empty(m, dtype=np.uint32)
        out[0] = 1
        k = 1
        while k < m:
            step = (int(out[k - 1]) * key) % P_INT  # base^k
            take = min(k, m - k)
            out[k : k + take] = (
                out[:take].astype(np.uint64) * np.uint64(step)
            ) % np.uint64(P_INT)
            k += take
        if len(_POWERS_CACHE) > 128:
            _POWERS_CACHE.clear()
        _POWERS_CACHE[key] = out
        cached = out
    return cached[:n].copy()


def bit_reverse_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for i in range(log_n):
        rev = (rev << np.uint32(1)) | ((idx >> np.uint32(i)) & np.uint32(1))
    return rev.astype(np.int64)


def reverse_bits_len(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r
