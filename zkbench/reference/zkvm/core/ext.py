"""Degree-4 binomial extension field F_p[x]/(x^4 - 3) over KoalaBear.

Matches the reference's `BinomialExtensionField<KoalaBear, 4>` (W = 3 verified
against crates/recursion/gnark-ffi/go/zkm/koalabear/koalabear.go `MulE`).

Elements are numpy uint32 arrays whose *last* axis has length 4
(coefficients a0 + a1 x + a2 x^2 + a3 x^3). All ops broadcast over leading
axes, so the same functions serve scalars ((4,) arrays) and columns
((n, 4) arrays).
"""

from __future__ import annotations

import numpy as np

from . import field as F

W = 4  # extension degree
EXT_W = 3  # x^4 = 3


def ezero(shape=()) -> np.ndarray:
    return np.zeros(shape + (4,), dtype=np.uint32)


def eone(shape=()) -> np.ndarray:
    out = np.zeros(shape + (4,), dtype=np.uint32)
    out[..., 0] = 1
    return out


def from_base(a) -> np.ndarray:
    """Embed base-field element(s) into the extension."""
    a = np.asarray(a, dtype=np.uint32)
    out = np.zeros(a.shape + (4,), dtype=np.uint32)
    out[..., 0] = a
    return out


def from_coeffs(c0, c1, c2, c3) -> np.ndarray:
    return np.stack(
        [np.asarray(c, dtype=np.uint32) for c in (c0, c1, c2, c3)], axis=-1
    )


def monomial(i: int) -> np.ndarray:
    out = np.zeros(4, dtype=np.uint32)
    out[i] = 1
    return out


def eadd(a, b):
    return F.fadd(a, b)


def esub(a, b):
    return F.fsub(a, b)


def eneg(a):
    return F.fneg(a)


def emul(a, b):
    """Schoolbook ext4 multiply with x^4 = 3 (exact reference semantics)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    p = np.uint64(F.P_INT)
    # accumulate products in uint64; max 4 terms * (2^31)^2 < 2^64 ✓ (4 * 2^62)
    # careful: 4 * (p-1)^2 ~ 2^63.8 < 2^64 OK; with the *3 factor 3*(p-1)^2*? —
    # reduce each pairwise product first to stay safe.
    def m(i, j):
        return (a[..., i] * b[..., j]) % p

    c0 = (m(0, 0) + 3 * ((m(1, 3) + m(2, 2) + m(3, 1)) % p)) % p
    c1 = (m(0, 1) + m(1, 0) + 3 * ((m(2, 3) + m(3, 2)) % p)) % p
    c2 = (m(0, 2) + m(1, 1) + m(2, 0) + 3 * m(3, 3)) % p
    c3 = (m(0, 3) + m(1, 2) + m(2, 1) + m(3, 0)) % p
    return np.stack([c0, c1, c2, c3], axis=-1).astype(np.uint32)


def emul_base(a, b):
    """ext * base."""
    b = np.asarray(b, dtype=np.uint32)
    return F.fmul(a, b[..., None])


def epow(a, e: int):
    result = np.broadcast_to(eone(np.asarray(a).shape[:-1]), np.asarray(a).shape).copy()
    base = np.asarray(a, dtype=np.uint32).copy()
    while e > 0:
        if e & 1:
            result = emul(result, base)
        base = emul(base, base)
        e >>= 1
    return result


# Frobenius: (x^i)^(p^k) = gamma_k^i x^i with gamma_k = 3^(i*(p-1)/4)... since
# p ≡ 1 (mod 4), x^p = 3^((p-1)/4) * x.
_GAMMA = pow(3, (F.P_INT - 1) // 4, F.P_INT)  # 4th root of unity scaling


def frobenius(a, k: int = 1):
    g = pow(_GAMMA, k, F.P_INT)
    scales = np.array(
        [pow(g, i, F.P_INT) for i in range(4)], dtype=np.uint32
    )
    return F.fmul(a, scales)


def einv(a):
    """Inverse via the norm: a^{-1} = prod_{k=1..3} a^{p^k} / N(a)."""
    b = emul(frobenius(a, 1), frobenius(a, 2))
    b = emul(b, frobenius(a, 3))
    norm = emul(a, b)  # lies in the base field: coeffs 1..3 are 0
    n0 = norm[..., 0]
    return emul_base(b, F.finv(n0))


def ediv(a, b):
    return emul(a, einv(b))


def esum(a, axis=0):
    """Sum ext elements along a leading axis."""
    t = np.sum(np.asarray(a, dtype=np.uint64), axis=axis)
    return (t % np.uint64(F.P_INT)).astype(np.uint32)


_POWERS_CACHE: dict = {}


def epowers(base, n: int) -> np.ndarray:
    """[1, base, ..., base^(n-1)], shape (n, 4). Cached per base and grown
    by doubling (hot in the prover: alpha powers per chip / per opening)."""
    key = bytes(np.asarray(base, np.uint32).tobytes())
    cached = _POWERS_CACHE.get(key)
    if cached is None or cached.shape[0] < n:
        m = max(16, 1 << (max(n, 1) - 1).bit_length())
        out = np.empty((m, 4), dtype=np.uint32)
        out[0] = eone()
        k = 1  # length of the valid prefix
        while k < m:
            step = emul(out[k - 1], np.asarray(base, np.uint32))  # base^k
            take = min(k, m - k)
            out[k : k + take] = emul(out[:take], step[None, :])
            k += take
        if len(_POWERS_CACHE) > 64:
            _POWERS_CACHE.clear()
        _POWERS_CACHE[key] = out
        cached = out
    return cached[:n].copy()


def as_base_slice(a) -> list:
    return [int(x) for x in np.asarray(a, dtype=np.uint32).reshape(-1)]


def ext_eq(a, b) -> bool:
    return bool(np.all(np.asarray(a, np.uint32) == np.asarray(b, np.uint32)))
