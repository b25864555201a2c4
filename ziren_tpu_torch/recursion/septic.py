"""Traced septic-curve arithmetic for the recursion circuits.

The cross-shard memory/syscall multiset digest is a point on the curve
y^2 = x^3 + 3z*x - 3 over F_{p^7} = F_p[z]/(z^7 + 2z - 8) (core/septic.py).
Joins must accumulate their children's per-shard digests IN-CIRCUIT so a
compressed proof attests cross-shard memory consistency
(reference: crates/recursion/compiler/src/circuit/builder.rs sum_digest_v2 /
assert_digest_zero_v2, crates/recursion/circuit/src/machine/compress.rs:451).

Curve addition is proven the reference's way: the result point is HINTED
(computed host-side during tracing) and pinned by the collinearity checker
identities, avoiding in-circuit field inversion:

    (x1 + x2 + x3) * (x2 - x1)^2 - (y2 - y1)^2          == 0
    (y3 + y1) * (x2 - x1)       - (y2 - y1) * (x1 - x3) == 0

valid whenever x1 != x2; the two distinct digest start constants
(DIGEST_SUM_START vs CURVE_CUMULATIVE_SUM_START) make the deterministic
exceptional cases unreachable, exactly as in the reference.

A "point" here is a pair (x, y) of 7-element lists of Felt handles.
"""

from __future__ import annotations

import numpy as np

from ..core import field as F
from ..core import septic as S

P = F.P_INT


# -- septic extension arithmetic over Felt limbs ----------------------------


def sep_add(a, b):
    return [a[i] + b[i] for i in range(7)]


def sep_sub(a, b):
    return [a[i] - b[i] for i in range(7)]


def sep_mul(t, a, b):
    """Schoolbook 7x7 multiply, then reduce by z^7 = 8 - 2z
    (mirrors core/septic.py smul)."""
    raw = [None] * 13
    for i in range(7):
        for j in range(7):
            p = a[i] * b[j]
            raw[i + j] = p if raw[i + j] is None else raw[i + j] + p
    for k in range(12, 6, -1):
        c = raw[k]
        raw[k - 7] = raw[k - 7] + c * 8
        raw[k - 6] = raw[k - 6] - (c + c)
    return raw[:7]


def sep_const(t, vals7):
    return [t.const(int(v)) for v in np.asarray(vals7, np.uint32)]


def point_const(t, xy):
    return (sep_const(t, xy[0]), sep_const(t, xy[1]))


def point_values(t, p):
    """Concrete numpy (x, y) of a traced point (requires concrete tracing)."""
    x = np.asarray([t.value(f) for f in p[0]], np.uint32)
    y = np.asarray([t.value(f) for f in p[1]], np.uint32)
    return (x, y)


def point_hint(t, xy):
    """Hint a concrete host point into the trace (caller must constrain)."""
    return (
        [t.hint(int(v)) for v in np.asarray(xy[0], np.uint32)],
        [t.hint(int(v)) for v in np.asarray(xy[1], np.uint32)],
    )


# -- curve addition (hinted result + collinearity checkers) -----------------


def traced_curve_add(t, p1, p2):
    """p3 = p1 + p2 with x1 != x2; the result is hinted and bound by the
    collinearity identities (reference builder.rs add_curve_v2)."""
    p1v = point_values(t, p1)
    p2v = point_values(t, p2)
    assert not np.array_equal(p1v[0], p2v[0]), (
        "exceptional septic addition (equal x): digest start constants "
        "should make this unreachable"
    )
    p3 = point_hint(t, S.curve_add(p1v, p2v))
    x1, y1 = p1
    x2, y2 = p2
    x3, y3 = p3
    dx = sep_sub(x2, x1)
    dy = sep_sub(y2, y1)
    dx2 = sep_mul(t, dx, dx)
    xsum = sep_add(sep_add(x1, x2), x3)
    chk_x = sep_sub(sep_mul(t, xsum, dx2), sep_mul(t, dy, dy))
    chk_y = sep_sub(
        sep_mul(t, sep_add(y3, y1), dx), sep_mul(t, dy, sep_sub(x1, x3))
    )
    zero = t.const(0)
    for c in chk_x + chk_y:
        t.assert_eq(c, zero)
    return p3


def traced_sum_digest(t, digests):
    """Sum of k digest-form points (each = zero_digest + actual sum) into
    one digest-form point (reference builder.rs sum_digest_v2):
        start + D_1 + (-Z) + D_2 + (-Z) ... + D_k + (-start)
    where Z is the zero digest and start the (distinct) digest-sum start."""
    start = point_const(t, (S.DIGEST_SUM_START_X, S.DIGEST_SUM_START_Y))
    if not digests:
        return point_const(
            t, (S.CURVE_CUMULATIVE_SUM_START_X, S.CURVE_CUMULATIVE_SUM_START_Y)
        )
    neg_zero = point_const(
        t,
        (
            S.CURVE_CUMULATIVE_SUM_START_X,
            S.sneg(S.CURVE_CUMULATIVE_SUM_START_Y),
        ),
    )
    neg_start = point_const(
        t, (S.DIGEST_SUM_START_X, S.sneg(S.DIGEST_SUM_START_Y))
    )
    ret = start
    for i, d in enumerate(digests):
        ret = traced_curve_add(t, ret, d)
        if i != len(digests) - 1:
            ret = traced_curve_add(t, ret, neg_zero)
    return traced_curve_add(t, ret, neg_start)


def assert_digest_zero(t, is_real, digest):
    """is_real * (digest - zero_digest) == 0 limb-wise (reference
    assert_digest_zero_v2): when is_real = 1 the accumulated digest must be
    the zero digest, i.e. the global multiset balances."""
    zx = np.asarray(S.CURVE_CUMULATIVE_SUM_START_X, np.uint32)
    zy = np.asarray(S.CURVE_CUMULATIVE_SUM_START_Y, np.uint32)
    zero = t.const(0)
    for limb, zv in list(zip(digest[0], zx)) + list(zip(digest[1], zy)):
        t.assert_eq(is_real * (limb - int(zv)), zero)


def host_sum_digest(digests):
    """Host-side mirror of traced_sum_digest (numpy points in digest form)."""
    start = (S.DIGEST_SUM_START_X.copy(), S.DIGEST_SUM_START_Y.copy())
    if not digests:
        return S.digest_zero()
    neg_zero = (
        S.CURVE_CUMULATIVE_SUM_START_X.copy(),
        S.sneg(S.CURVE_CUMULATIVE_SUM_START_Y),
    )
    ret = start
    for i, d in enumerate(digests):
        ret = S.curve_add(ret, d)
        if i != len(digests) - 1:
            ret = S.curve_add(ret, neg_zero)
    neg_start = (S.DIGEST_SUM_START_X.copy(), S.sneg(S.DIGEST_SUM_START_Y))
    return S.curve_add(ret, neg_start)
