"""Septic extension field F_{p^7} = F_p[z]/(z^7 + 2z - 8), the elliptic
curve y^2 = x^3 + 3z*x - 3 over it, and the cross-shard digest
(reference: crates/stark/src/septic_extension.rs, septic_curve.rs,
septic_digest.rs).

The global (cross-shard) memory/syscall multiset is hashed by mapping each
message to a curve point and summing points; the digest starting points
avoid Weierstrass addition exceptions. Constants are copied verbatim from
the reference so digests stay interoperable.

Vectorized: elements are uint32 arrays with trailing axis 7; points are
(x, y) pairs.
"""

from __future__ import annotations

import numpy as np

from . import field as F

P = np.uint64(F.P_INT)

# z^7 = -2z + 8
CURVE_WITNESS_DUMMY_POINT_X = np.array(
    [1706420302, 1319108093, 148224806, 26874985, 1766171812, 1645633948, 2028659224],
    dtype=np.uint32,
)
CURVE_WITNESS_DUMMY_POINT_Y = np.array(
    [942390502, 1239997438, 458866455, 1843332012, 1309764648, 572807436, 74267719],
    dtype=np.uint32,
)
CURVE_CUMULATIVE_SUM_START_X = np.array(
    [637514027, 1595065213, 1998064738, 72333738, 1211544370, 822986770, 1518535784],
    dtype=np.uint32,
)
CURVE_CUMULATIVE_SUM_START_Y = np.array(
    [1604177449, 90440090, 259343427, 140470264, 1162099742, 941559812, 1064053343],
    dtype=np.uint32,
)
DIGEST_SUM_START_X = np.array(
    [1656788302, 897965284, 874620737, 1581672598, 655804282, 1962911564, 80580607],
    dtype=np.uint32,
)
DIGEST_SUM_START_Y = np.array(
    [1024875409, 218609128, 1856341123, 583920580, 1274441611, 118766316, 81843042],
    dtype=np.uint32,
)


def szero(shape=()):
    return np.zeros(shape + (7,), dtype=np.uint32)


def sone(shape=()):
    out = np.zeros(shape + (7,), dtype=np.uint32)
    out[..., 0] = 1
    return out


def from_base(a):
    a = np.asarray(a, dtype=np.uint32)
    out = np.zeros(a.shape + (7,), dtype=np.uint32)
    out[..., 0] = a
    return out


def sadd(a, b):
    return F.fadd(a, b)


def ssub(a, b):
    return F.fsub(a, b)


def sneg(a):
    return F.fneg(a)


def _smul_scalar(a, b):
    """Python-int fast path for single elements (hot in sqrt/lift_x)."""
    aa = [int(x) for x in a]
    bb = [int(x) for x in b]
    raw = [0] * 13
    for i in range(7):
        ai = aa[i]
        if ai:
            for j in range(7):
                raw[i + j] += ai * bb[j]
    p = F.P_INT
    for k in range(12, 6, -1):
        c = raw[k]
        if c:
            raw[k - 7] += 8 * c
            raw[k - 6] -= 2 * c
    return np.array([raw[i] % p for i in range(7)], dtype=np.uint32)


def smul(a, b):
    """Schoolbook multiply then reduce by z^7 = -2z + 8."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    if a.ndim == 1 and b.ndim == 1:
        return _smul_scalar(a, b)
    # raw product coefficients (degree up to 12); reduce pairwise mod p as we
    # accumulate (7 terms * (2^31)^2 < 2^65 would overflow, so reduce partials)
    shape = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    raw = np.zeros(shape + (13,), dtype=np.uint64)
    for i in range(7):
        for j in range(7):
            raw[..., i + j] += (a[..., i] * b[..., j]) % P
        raw %= P
    # reduce degrees 12..7: z^k = z^(k-7) * (8 - 2z)
    for k in range(12, 6, -1):
        c = raw[..., k].copy()
        raw[..., k] = 0
        raw[..., k - 7] = (raw[..., k - 7] + 8 * c) % P
        raw[..., k - 6] = (raw[..., k - 6] + (2 * (P - c)) % P) % P
    return raw[..., :7].astype(np.uint32)


def smul_base(a, s):
    return F.fmul(a, np.asarray(s, np.uint32)[..., None])


def spow(a, e: int):
    result = np.broadcast_to(sone(np.asarray(a).shape[:-1]), np.asarray(a).shape).copy()
    base = np.asarray(a, dtype=np.uint32)
    while e > 0:
        if e & 1:
            result = smul(result, base)
        base = smul(base, base)
        e >>= 1
    return result


def sinv(a):
    """Inverse via x^(p^7 - 2); uses the norm trick through Frobenius powers.

    r = (p^7 - 1) / (p - 1); x^r lies in F_p, so
    x^{-1} = x^{r-1} / N(x) with N(x) = x^r.
    """
    # pow_r_1 = x^{p + p^2 + ... + p^6} via frobenius composition
    base = smul(frobenius(a, 1), frobenius(a, 2))
    base_p2 = frobenius_of(base, 2)
    base_p4 = frobenius_of(base_p2, 2)
    pow_r_1 = smul(smul(base_p4, base_p2), base)
    norm = smul(pow_r_1, a)  # in F_p: coefficients 1..6 are 0
    n0 = norm[..., 0]
    return smul_base(pow_r_1, F.finv(n0))


# Frobenius: z^p = sum_k c_k z^k precomputed from z^p mod (z^7 + 2z - 8)
def _zpow_mod(e: int) -> list:
    """z^e mod (z^7 + 2z - 8) as 7 coefficients (python ints)."""
    # polynomial as dict degree -> coeff
    poly = {1: 1}  # z
    result = {0: 1}
    ebits = bin(e)[2:]

    def pmul(p1, p2):
        out = {}
        for d1, c1 in p1.items():
            for d2, c2 in p2.items():
                out[d1 + d2] = (out.get(d1 + d2, 0) + c1 * c2) % F.P_INT
        # reduce
        while max(out) > 6:
            d = max(out)
            c = out.pop(d)
            if c:
                out[d - 7] = (out.get(d - 7, 0) + 8 * c) % F.P_INT
                out[d - 6] = (out.get(d - 6, 0) - 2 * c) % F.P_INT
        return {d: c for d, c in out.items() if c}

    for bit in ebits:
        result = pmul(result, result)
        if bit == "1":
            result = pmul(result, poly)
    return [result.get(i, 0) for i in range(7)]


# frobenius matrices built iteratively: z^(p^k) = frob applied k times
def _build_frob():
    zp = _zpow_mod(F.P_INT)  # z^p
    zp_arr = np.array(zp, dtype=np.uint32)

    def poly_pow_compose(coeffs):
        """Given w = sum c_i z^i, compute powers w^0..w^6 as (7,7) matrix."""
        rows = [sone()]
        cur = sone()
        w = np.array(coeffs, dtype=np.uint32)
        for _ in range(6):
            cur = smul(cur, w)
            rows.append(cur)
        return np.stack(rows)  # (7, 7): row i = w^i coefficients

    mats = {0: np.eye(7, dtype=np.uint32)}
    m1 = poly_pow_compose(zp_arr)  # maps z^i -> (z^p)^i
    mats[1] = m1
    for k in range(2, 7):
        # frob^k matrix = apply frob to each row of frob^(k-1)
        prev = mats[k - 1]
        mats[k] = np.stack([_apply_matrix(m1, prev[i]) for i in range(7)])
    return mats


def _apply_matrix(mat, coeffs):
    """sum_i coeffs[i] * mat[i] (mod p)."""
    acc = np.zeros(7, dtype=np.uint64)
    for i in range(7):
        acc = (acc + np.uint64(int(coeffs[i])) * mat[i].astype(np.uint64)) % P
    return acc.astype(np.uint32)


_FROB_MATS = None


def frobenius(a, k: int = 1):
    """a^(p^k), vectorized."""
    global _FROB_MATS
    if _FROB_MATS is None:
        _FROB_MATS = _build_frob()
    return frobenius_of(a, k)


def frobenius_of(a, k: int):
    mat = _FROB_MATS[k % 7].astype(np.uint64)  # (7in, 7out)
    a = np.asarray(a, dtype=np.uint64)
    # out = sum_i a[..., i] * mat[i]
    out = np.zeros(a.shape, dtype=np.uint64)
    for i in range(7):
        out = (out + a[..., i : i + 1] * mat[i]) % P
    return out.astype(np.uint32)


# ---------------------------------------------------------------------------
# Curve y^2 = x^3 + 3z*x - 3
# ---------------------------------------------------------------------------

_A = None  # 3z
_B3 = None  # constant -3


def _curve_consts():
    global _A, _B3
    if _A is None:
        _A = szero()
        _A[1] = 3
        _B3 = from_base(np.uint32(F.P_INT - 3))
    return _A, _B3


def curve_is_on(x, y) -> bool:
    a, b = _curve_consts()
    lhs = smul(y, y)
    rhs = sadd(sadd(smul(smul(x, x), x), smul(a, x)), b)
    return bool(np.array_equal(lhs, rhs))


def curve_add(p1, p2):
    """Affine addition (points must be distinct and nonzero; the digest
    start points make exceptions unreachable, reference septic_digest.rs)."""
    (x1, y1), (x2, y2) = p1, p2
    slope = smul(ssub(y2, y1), sinv(ssub(x2, x1)))
    x3 = ssub(ssub(smul(slope, slope), x1), x2)
    y3 = ssub(smul(slope, ssub(x1, x3)), y1)
    return (x3, y3)


def curve_double(p1):
    a, _ = _curve_consts()
    x1, y1 = p1
    num = sadd(smul_base(smul(x1, x1), np.uint32(3)), a)
    slope = smul(num, sinv(smul_base(y1, np.uint32(2))))
    x3 = ssub(ssub(smul(slope, slope), x1), x1)
    y3 = ssub(smul(slope, ssub(x1, x3)), y1)
    return (x3, y3)


def curve_neg(p1):
    x1, y1 = p1
    return (x1, sneg(y1))


def digest_zero():
    return (
        CURVE_CUMULATIVE_SUM_START_X.copy(),
        CURVE_CUMULATIVE_SUM_START_Y.copy(),
    )


def digest_sum(points) -> tuple:
    """Sum of digests with the special start-point logic
    (reference: septic_digest.rs Sum impl): start + sum(point - start)."""
    start = digest_zero()
    acc = start
    for p in points:
        acc = curve_add(acc, curve_add(p, curve_neg(start)))
    return acc


def digest_is_zero(p) -> bool:
    z = digest_zero()
    return bool(np.array_equal(p[0], z[0]) and np.array_equal(p[1], z[1]))


# ---------------------------------------------------------------------------
# Square roots (Cipolla) and hash-to-curve (reference: septic_extension.rs
# sqrt/is_square, septic_curve.rs lift_x)
# ---------------------------------------------------------------------------

_Q = F.P_INT**7
_HALF_EXP = (_Q - 1) // 2
_CIPOLLA_EXP = (_Q + 1) // 2


def is_square(a) -> bool:
    r = spow(a, _HALF_EXP)
    return bool(np.array_equal(r, sone()))


def ssqrt(a):
    """Square root in F_{p^7} via Cipolla's algorithm; None if non-square."""
    a = np.asarray(a, dtype=np.uint32)
    if np.all(a == 0):
        return szero()
    if not is_square(a):
        return None
    # find t with t^2 - a a non-square
    t = szero()
    for cand in range(1, 1000):
        t = szero()
        t[0] = cand % F.P_INT
        t[1] = cand // F.P_INT  # walk t = c0 + c1 z if needed
        d = ssub(smul(t, t), a)
        if not is_square(d):
            break
    d = ssub(smul(t, t), a)
    # compute (t + w)^((q+1)/2) in F_q[w]/(w^2 - d)
    xr, xi = t.copy(), sone()
    rr, ri = sone(), szero()
    e = _CIPOLLA_EXP
    while e > 0:
        if e & 1:
            rr, ri = (
                sadd(smul(rr, xr), smul(smul(ri, xi), d)),
                sadd(smul(rr, xi), smul(ri, xr)),
            )
        xr, xi = (
            sadd(smul(xr, xr), smul(smul(xi, xi), d)),
            smul_base(smul(xr, xi), np.uint32(2)),
        )
        e >>= 1
    assert np.all(ri == 0), "cipolla: imaginary part nonzero"
    return rr


def curve_formula(x):
    a, b = _curve_consts()
    return sadd(sadd(smul(smul(x, x), x), smul(a, x)), b)


def y_is_receive(y) -> bool:
    y6 = int(y[6])
    return 1 <= y6 <= (F.P_INT - 1) // 2


def y_is_exception(y) -> bool:
    return int(y[6]) == 0


def lift_x(m7):
    """Message (7,) -> (point (x, y_receive), offset byte)
    (reference: septic_curve.rs:130 — x6 = m6 * 256 + offset; y returned in
    the receive range; sends use -y). Dispatches to the native (C++) path
    when available; `_lift_x_py` is the semantic oracle."""
    m7 = np.asarray(m7, dtype=np.uint32)
    from . import p2_native

    if p2_native.available():
        xs, ys, offs = p2_native.septic_lift_x(m7[None, :])
        return (xs[0], ys[0]), int(offs[0])
    return _lift_x_py(m7)


def lift_x_batch(msgs):
    """Batched hash-to-curve: (n, 7) -> (xs (n,7), ys (n,7), offsets (n,))."""
    msgs = np.asarray(msgs, dtype=np.uint32).reshape(-1, 7)
    from . import p2_native

    if p2_native.available():
        return p2_native.septic_lift_x(msgs)
    xs = np.empty_like(msgs)
    ys = np.empty_like(msgs)
    offs = np.empty(msgs.shape[0], dtype=np.uint32)
    for i, m in enumerate(msgs):
        (x, y), o = _lift_x_py(m)
        xs[i], ys[i], offs[i] = x, y, o
    return xs, ys, offs


def _lift_x_py(m7):
    for offset in range(256):
        x = m7.copy()
        x[6] = (int(m7[6]) * 256 + offset) % F.P_INT
        y = ssqrt(curve_formula(x))
        if y is None or y_is_exception(y):
            continue
        if not y_is_receive(y):
            y = sneg(y)
        return (x, y), offset
    raise ValueError("curve point not found after 256 offsets")


def complete_add(p1, p2):
    """Curve addition with infinity (None) and doubling handled."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    if np.array_equal(p1[0], p2[0]):
        if np.array_equal(p1[1], sneg(p2[1])):
            return None
        return curve_double(p1)
    return curve_add(p1, p2)


def digests_balance(digests) -> bool:
    """True iff sum_i (D_i - start) is the point at infinity
    (reference: machine.rs:659-674 global cumulative sum check)."""
    start = digest_zero()
    neg_start = curve_neg(start)
    total = None
    for d in digests:
        d = (np.asarray(d[0], np.uint32), np.asarray(d[1], np.uint32))
        if np.array_equal(d[0], start[0]) and np.array_equal(d[1], start[1]):
            continue  # D == start contributes zero
        total = complete_add(total, complete_add(d, neg_start))
    return total is None
