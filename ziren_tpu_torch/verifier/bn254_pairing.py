"""BN254 (alt_bn128) optimal-ate pairing over python ints.

Self-contained tower arithmetic for the portable Groth16/Plonk verifiers
(reference uses substrate_bn — crates/verifier/src/groth16/verify.rs). The
construction is the standard BN254 tower: Fq2 = Fq[u]/(u^2+1), G2 on the
sextic twist y^2 = x^3 + 3/(9+u), pairings computed by untwisting into
Fq12 = Fq[w]/(w^12 - 18 w^6 + 82) and running the Miller loop with the
classic line functions, exponent 6t+2, plus the two Frobenius line steps.

Performance shape: one pairing ~0.3 s, a 4-term pairing product shares one
final exponentiation — adequate for one-shot proof verification.
"""

from __future__ import annotations

# base field / scalar field
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

B1 = 3  # G1: y^2 = x^3 + 3
ATE_LOOP_COUNT = 29793968203157093288  # 6t + 2
LOG_ATE = 63

# Fq12 = Fq[w] / (w^12 - 18 w^6 + 82)
_FQ12_MOD = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0]


def _inv(a: int, p: int = Q) -> int:
    return pow(a % p, p - 2, p)


class FQ2:
    """Fq[u]/(u^2+1), coeffs (c0, c1) = c0 + c1 u."""

    __slots__ = ("c",)

    def __init__(self, c):
        self.c = (c[0] % Q, c[1] % Q)

    def __add__(self, o):
        return FQ2((self.c[0] + o.c[0], self.c[1] + o.c[1]))

    def __sub__(self, o):
        return FQ2((self.c[0] - o.c[0], self.c[1] - o.c[1]))

    def __neg__(self):
        return FQ2((-self.c[0], -self.c[1]))

    def __mul__(self, o):
        if isinstance(o, int):
            return FQ2((self.c[0] * o, self.c[1] * o))
        a0, a1 = self.c
        b0, b1 = o.c
        return FQ2((a0 * b0 - a1 * b1, a0 * b1 + a1 * b0))

    def inv(self):
        a0, a1 = self.c
        d = _inv(a0 * a0 + a1 * a1)
        return FQ2((a0 * d, -a1 * d))

    def __eq__(self, o):
        return self.c == o.c

    def is_zero(self):
        return self.c == (0, 0)


FQ2_ONE = FQ2((1, 0))
FQ2_ZERO = FQ2((0, 0))
# G2: y^2 = x^3 + 3/(9+u)
B2 = FQ2((3, 0)) * FQ2((9, 1)).inv()


class FQ12:
    """Fq[w]/(w^12 - 18 w^6 + 82), dense coefficient vector of 12 ints."""

    __slots__ = ("c",)

    def __init__(self, c):
        assert len(c) == 12
        self.c = [v % Q for v in c]

    @staticmethod
    def one():
        return FQ12([1] + [0] * 11)

    def __add__(self, o):
        return FQ12([a + b for a, b in zip(self.c, o.c)])

    def __sub__(self, o):
        return FQ12([a - b for a, b in zip(self.c, o.c)])

    def __neg__(self):
        return FQ12([-a for a in self.c])

    def __mul__(self, o):
        if isinstance(o, int):
            return FQ12([a * o for a in self.c])
        t = [0] * 23
        a, b = self.c, o.c
        for i in range(12):
            ai = a[i]
            if ai:
                for j in range(12):
                    t[i + j] += ai * b[j]
        for k in range(22, 11, -1):
            v = t[k]
            if v:
                # w^12 = 18 w^6 - 82
                t[k - 6] += v * 18
                t[k - 12] -= v * 82
        return FQ12(t[:12])

    def square(self):
        return self * self

    def inv(self):
        # extended Euclid over the polynomial ring
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self.c) + [0]
        high = [m % Q for m in _FQ12_MOD] + [1]

        def deg(p):
            for i in range(len(p) - 1, -1, -1):
                if p[i]:
                    return i
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = list(a)
            o = [0] * len(a)
            for i in range(dega - degb, -1, -1):
                q = temp[degb + i] * _inv(b[degb]) % Q
                o[i] = q
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - o[i] * b[c]) % Q
            return [x % Q for x in o[: deg(o) + 1]]

        while deg(low):
            r = poly_rounded_div(high, low)
            r += [0] * (13 - len(r))
            nm = list(hm)
            new = list(high)
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % Q for x in nm]
            new = [x % Q for x in new]
            lm, low, hm, high = nm, new, lm, low
        d = _inv(low[0])
        return FQ12([x * d for x in lm[:12]])

    def pow(self, e: int):
        result = FQ12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __eq__(self, o):
        return self.c == o.c


# ---------------------------------------------------------------------------
# curve ops (generic over FQ2 / FQ12 / int coordinates); points are (x, y)
# tuples or None for infinity
# ---------------------------------------------------------------------------


def _double(pt):
    if pt is None:
        return None
    x, y = pt
    if isinstance(x, int):
        lam = 3 * x * x % Q * _inv(2 * y) % Q
        nx = (lam * lam - 2 * x) % Q
        return (nx, (lam * (x - nx) - y) % Q)
    lam = (x * x * 3) * (y * 2).inv()
    nx = lam * lam - x * 2
    return (nx, lam * (x - nx) - y)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if isinstance(x1, int):
        if x1 == x2:
            if y1 == y2:
                return _double(p1)
            return None
        lam = (y2 - y1) * _inv(x2 - x1) % Q
        nx = (lam * lam - x1 - x2) % Q
        return (nx, (lam * (x1 - nx) - y1) % Q)
    if x1 == x2:
        if y1 == y2:
            return _double(p1)
        return None
    lam = (y2 - y1) * (x2 - x1).inv()
    nx = lam * lam - x1 - x2
    return (nx, lam * (x1 - nx) - y1)


def g1_mul(pt, n: int):
    if n % R == 0 or pt is None:
        return None
    result = None
    addend = pt
    n = n % R
    while n:
        if n & 1:
            result = _add(result, addend)
        addend = _double(addend)
        n >>= 1
    return result


g2_mul = g1_mul  # same generic ladder


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % Q)


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


def is_on_g1(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B1) % Q == 0


def is_on_g2(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B2).is_zero()


def g2_y_from_x(x: FQ2):
    """(y, -y) with y^2 = x^3 + b2, or None if no root. The returned y is
    the root with the lexicographically SMALLER encoding (c1, then c0) —
    gnark's convention for the 'positive' point."""
    rhs = x * x * x + B2
    y = _fq2_sqrt(rhs)
    if y is None:
        return None
    ny = -y
    return (y, ny) if _fq2_lex_le(y, ny) else (ny, y)


def g1_y_from_x(x: int):
    """(y, -y) with y^2 = x^3 + 3, y <= -y lexicographically."""
    rhs = (x * x * x + B1) % Q
    y = pow(rhs, (Q + 1) // 4, Q)
    if y * y % Q != rhs:
        return None
    ny = (-y) % Q
    return (y, ny) if y <= ny else (ny, y)


def _fq2_lex_le(a: FQ2, b: FQ2) -> bool:
    """Lexicographic order on (c1, c0) — gnark-crypto's LexicographicallyLargest
    checks c1 first, then c0 (bn254/fq2 lexicographic rules)."""
    if a.c[1] != b.c[1]:
        return a.c[1] < b.c[1]
    return a.c[0] <= b.c[0]


def _fq2_sqrt(a: FQ2):
    """Square root in Fq2 via the norm trick (q = 3 mod 4)."""
    if a.is_zero():
        return FQ2_ZERO
    a0, a1 = a.c
    if a1 == 0:
        r = pow(a0, (Q + 1) // 4, Q)
        if r * r % Q == a0:
            return FQ2((r, 0))
        # sqrt(a0) = sqrt(-a0) * u since u^2 = -1
        r = pow((-a0) % Q, (Q + 1) // 4, Q)
        if r * r % Q == (-a0) % Q:
            return FQ2((0, r))
        return None
    norm = (a0 * a0 + a1 * a1) % Q
    n = pow(norm, (Q + 1) // 4, Q)
    if n * n % Q != norm:
        return None
    x0 = (a0 + n) % Q * _inv(2) % Q
    x = pow(x0, (Q + 1) // 4, Q)
    if x * x % Q != x0:
        x0 = (a0 - n) % Q * _inv(2) % Q
        x = pow(x0, (Q + 1) // 4, Q)
        if x * x % Q != x0:
            return None
    y = a1 * _inv(2 * x) % Q
    cand = FQ2((x, y))
    return cand if (cand * cand) == a else None


# ---------------------------------------------------------------------------
# pairing: twist G2 into FQ12, Miller loop, final exponentiation
# ---------------------------------------------------------------------------

_W2 = FQ12([0, 0, 1] + [0] * 9)  # w^2
_W3 = FQ12([0, 0, 0, 1] + [0] * 8)  # w^3


def twist(pt):
    """G2 (FQ2 coords) -> curve over FQ12 (untwist embedding)."""
    if pt is None:
        return None
    x, y = pt
    # map u -> w^6 - 9: coefficients of c0 + c1*u become c0 - 9 c1 + c1 w^6
    xc = [(x.c[0] - 9 * x.c[1]) % Q, x.c[1]]
    yc = [(y.c[0] - 9 * y.c[1]) % Q, y.c[1]]
    nx = FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (nx * _W2, ny * _W3)


def cast_g1(pt):
    if pt is None:
        return None
    return (FQ12([pt[0]] + [0] * 11), FQ12([pt[1]] + [0] * 11))


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at t (all FQ12 points)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1.c != x2.c:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1.c == y2.c:
        m = (x1 * x1 * 3) * (y1 * 2).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q_tw, p_cast, exponentiate: bool = True):
    """Optimal ate Miller loop on a twisted G2 point and a cast G1 point."""
    if q_tw is None or p_cast is None:
        return FQ12.one()
    r_pt = q_tw
    f = FQ12.one()
    for i in range(LOG_ATE, -1, -1):
        f = f * f * _linefunc(r_pt, r_pt, p_cast)
        r_pt = _double(r_pt)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(r_pt, q_tw, p_cast)
            r_pt = _add(r_pt, q_tw)
    # Frobenius steps: Q1 = pi(Q), nQ2 = -pi^2(Q)
    q1 = (q_tw[0].pow(Q), q_tw[1].pow(Q))
    nq2 = (q1[0].pow(Q), -(q1[1].pow(Q)))
    f = f * _linefunc(r_pt, q1, p_cast)
    r_pt = _add(r_pt, q1)
    f = f * _linefunc(r_pt, nq2, p_cast)
    if exponentiate:
        return final_exponentiate(f)
    return f


def final_exponentiate(f: FQ12) -> FQ12:
    return f.pow((Q**12 - 1) // R)


def pairing(q_pt, p_pt, exponentiate: bool = True) -> FQ12:
    """e(P in G1, Q in G2)."""
    assert is_on_g1(p_pt) and is_on_g2(q_pt)
    return miller_loop(twist(q_pt), cast_g1(p_pt), exponentiate)


def pairing_batch(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, sharing one final exponentiation.
    pairs: [(g1_point, g2_point)]."""
    f = FQ12.one()
    for p_pt, q_pt in pairs:
        assert is_on_g1(p_pt), "G1 point not on curve"
        assert is_on_g2(q_pt), "G2 point not on curve"
        f = f * miller_loop(twist(q_pt), cast_g1(p_pt), exponentiate=False)
    return final_exponentiate(f) == FQ12.one()
