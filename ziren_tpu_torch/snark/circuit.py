"""Dual-field circuit DSL: BN254-Fr R1CS with emulated KoalaBear arithmetic.

The reference wraps its outer STARK proof for EVM verification by compiling
the BN254-config STARK verifier into a gnark circuit (reference:
crates/recursion/circuit/src/lib.rs OuterConfig = Var<Bn254Fr> +
Felt<KoalaBear> + Ext<...>, and gnark-ffi/go/zkm/babybear's emulated field
chip). Go/gnark is unavailable here, so this module provides the same two
value planes natively over our in-house Groth16 layer (snark/groth16.py):

  * `Var`   — a native BN254-Fr wire: a sparse linear combination over R1CS
    wires with the concrete value carried alongside (the builder runs in
    witness mode, like gnark's Define+Solve in one pass; the constraint
    SYSTEM depends only on proof shape, never on values).
  * `Felt`  — an emulated KoalaBear element: a Var whose integer value is
    tracked with a worst-case bound for LAZY REDUCTION (gnark babybear
    chip's `reduceFast`): adds/muls accumulate without modular reduction
    until the bound nears the Fr capacity, then one hinted Euclidean
    division (value = q*p + r) plus bit range checks lands it back in
    [0, 2^31). Canonical form ([0, p)) is only forced where the transcript
    packs exact integers (reduce_32) or at equality assertions.
  * `Ext`   — degree-4 extension (x^4 = 3, core/ext.py) over Felt.

Constraints are emitted straight into snark/groth16.py's sparse R1CS
(A_k·w * B_k·w = C_k·w, wire 0 ≡ 1), so a built circuit Groth16-proves and
verifies with the in-house gnark-byte-compatible pipeline.
"""

from __future__ import annotations

from ..core.bn254 import FR, KB_P

P = KB_P
# reduce a Felt once its bound threatens Fr soundness: every intermediate
# (including a 2x headroom for the lifted subtraction/add) must stay below
# FR (253.5 bits). Wider capacity = rarer reductions: a reduce costs
# ~bound_bits constraints, so amortized cost per mul falls as the chain
# runs longer between reductions (gnark babybear reduceFast rationale).
_BOUND_LIMIT = 1 << 248
_W = 4  # ext degree


class CircuitBuilder:
    """Accumulates an R1CS while evaluating the circuit on live values."""

    def __init__(self):
        self.witness: list[int] = [1]
        self.num_public = 0
        self.a: list[dict] = []
        self.b: list[dict] = []
        self.c: list[dict] = []
        self._sealed_public = False

    # -- wires -------------------------------------------------------------
    def public(self, value: int) -> "Var":
        """Allocate a public-input wire (must precede all private wires)."""
        assert not self._sealed_public, "public inputs must be allocated first"
        assert len(self.witness) == self.num_public + 1
        self.num_public += 1
        idx = self._new_wire(int(value) % FR)
        return Var(self, {idx: 1}, int(value) % FR)

    def wit(self, value: int) -> "Var":
        """Allocate a private witness wire carrying `value`."""
        self._sealed_public = True
        idx = self._new_wire(int(value) % FR)
        return Var(self, {idx: 1}, int(value) % FR)

    def const(self, value: int) -> "Var":
        return Var(self, {}, int(value) % FR)

    def _new_wire(self, value: int) -> int:
        self.witness.append(value % FR)
        return len(self.witness) - 1

    # -- constraints ---------------------------------------------------------
    def _constrain(self, a: dict, b: dict, c: dict):
        self.a.append(a)
        self.b.append(b)
        self.c.append(c)

    def mul(self, x: "Var", y: "Var") -> "Var":
        """x*y with one R1CS constraint (constant operands fold for free)."""
        if not x.lc:
            return y.scale(x.val)
        if not y.lc:
            return x.scale(y.val)
        self._sealed_public = True
        out_val = (x.val * y.val) % FR
        idx = self._new_wire(out_val)
        self._constrain(x._row(), y._row(), {idx: 1})
        return Var(self, {idx: 1}, out_val)

    def assert_zero_var(self, x: "Var"):
        assert x.val == 0, f"assert_zero on nonzero value {x.val}"
        self._constrain(x._row(), {0: 1}, {})

    def assert_bool(self, x: "Var"):
        assert x.val in (0, 1)
        row = x._row()
        self._constrain(row, dict(row), dict(row))  # x*x = x

    def bit_wit(self, value: int) -> "Var":
        v = self.wit(value & 1)
        self.assert_bool(v)
        return v

    def bits_of(self, x: "Var", n: int) -> list:
        """Decompose x into n LE bits (n bool constraints + 1 recompose).
        Sound only when x's canonical integer is known < 2^n and 2^n < FR
        (n <= 252): the bit sum cannot alias x + FR."""
        assert n <= 252, "use strict_bits_of for full-width Fr decomposition"
        assert x.val < (1 << n), f"value {x.val} exceeds {n} bits"
        bits = [self.bit_wit((x.val >> i) & 1) for i in range(n)]
        acc = self.const(0)
        for i, bb in enumerate(bits):
            acc = acc + bb.scale(1 << i)
        self.assert_zero_var(acc - x)
        return bits

    def strict_bits_of(self, x: "Var") -> list:
        """Full 254-bit decomposition with a bits < FR comparison chain
        (circomlib Num2Bits_strict): the canonical integer of an Fr wire is
        unique only once the bit vector is pinned below the modulus."""
        bits = [self.bit_wit((x.val >> i) & 1) for i in range(254)]
        acc = self.const(0)
        for i, bb in enumerate(bits):
            acc = acc + bb.scale(1 << i)
        self.assert_zero_var(acc - x)
        # enforce sum(bits) <= FR - 1, MSB-first compare against constant
        cbits = [(FR - 1) >> i & 1 for i in range(254)]
        # lt_or_eq chain: eq = prod over processed prefix of (bit matches)
        # working MSB->LSB; violation iff some prefix equal and bit>cbit
        eq = self.const(1)
        for i in range(253, -1, -1):
            bi = bits[i]
            if cbits[i] == 1:
                # bi may be 0 or 1; if 0, strictly less from here on
                eq = self.mul(eq, bi)
            else:
                # bi must be 0 whenever still equal-so-far: eq * bi == 0
                prod = self.mul(eq, bi)
                self.assert_zero_var(prod)
        return bits

    def select(self, bit: "Var", t: "Var", f: "Var") -> "Var":
        """bit ? t : f (bit must be boolean-constrained)."""
        return f + self.mul(bit, t - f)

    # -- satisfiability / export ---------------------------------------------
    def check(self) -> bool:
        w = self.witness
        for a, b, c in zip(self.a, self.b, self.c):
            av = sum(co * w[i] for i, co in a.items()) % FR
            bv = sum(co * w[i] for i, co in b.items()) % FR
            cv = sum(co * w[i] for i, co in c.items()) % FR
            if (av * bv) % FR != cv:
                return False
        return True

    def to_r1cs(self):
        from .groth16 import R1CS

        return R1CS(
            num_wires=len(self.witness),
            num_public=self.num_public,
            a=self.a,
            b=self.b,
            c=self.c,
        )

    @property
    def num_constraints(self) -> int:
        return len(self.a)


class Var:
    """Sparse Fr linear combination (wire 0 carries the constant term)."""

    __slots__ = ("bld", "lc", "val")

    def __init__(self, bld: CircuitBuilder, lc: dict, val: int):
        self.bld = bld
        self.lc = lc  # {wire: coeff}, EXCLUDING wire 0
        self.val = val % FR

    def _row(self) -> dict:
        """LC as an R1CS row including the constant at wire 0."""
        row = dict(self.lc)
        cst = (self.val - sum(co * self.bld.witness[i] for i, co in self.lc.items())) % FR
        if cst:
            row[0] = cst
        return row

    @property
    def _const_part(self) -> int:
        return (self.val - sum(co * self.bld.witness[i] for i, co in self.lc.items())) % FR

    def __add__(self, o: "Var") -> "Var":
        lc = dict(self.lc)
        for i, co in o.lc.items():
            nc = (lc.get(i, 0) + co) % FR
            if nc:
                lc[i] = nc
            else:
                lc.pop(i, None)
        return Var(self.bld, lc, self.val + o.val)

    def __sub__(self, o: "Var") -> "Var":
        return self + o.scale(FR - 1)

    def scale(self, k: int) -> "Var":
        k %= FR
        if k == 0:
            return Var(self.bld, {}, 0)
        return Var(
            self.bld, {i: (co * k) % FR for i, co in self.lc.items()},
            self.val * k,
        )

    def add_const(self, k: int) -> "Var":
        return Var(self.bld, dict(self.lc), self.val + k)


# -- emulated KoalaBear ------------------------------------------------------


class Felt:
    """KoalaBear element emulated in Fr with a tracked integer bound.

    `var.val` is the TRUE integer (< bound), not yet reduced mod p; all
    arithmetic stays exact over Z until `reduce`/`canon`.
    """

    __slots__ = ("var", "bound")

    def __init__(self, var: Var, bound: int):
        assert bound < FR, "Felt bound overflow — reduce earlier"
        self.var = var
        self.bound = bound

    @property
    def bld(self) -> CircuitBuilder:
        return self.var.bld

    @property
    def val(self) -> int:
        """Canonical KB value."""
        return self.var.val % P


def felt_wit(bld: CircuitBuilder, value: int, canon: bool = True) -> Felt:
    """Fresh witness Felt, range-checked to 31 bits (canon adds < p)."""
    value = int(value) % P
    v = bld.wit(value)
    bld.bits_of(v, 31)
    if canon:
        _check_lt_p(bld, v)
    return Felt(v, P - 1 if canon else (1 << 31) - 1)


def felt_public(bld: CircuitBuilder, value: int) -> Felt:
    """Public-input Felt (canonical range enforced in-circuit)."""
    value = int(value) % P
    v = bld.public(value)
    return Felt(v, P - 1)


def _checked_public_felt_range(bld: CircuitBuilder, f: Felt) -> Felt:
    bld.bits_of(f.var, 31)
    _check_lt_p(bld, f.var)
    return Felt(f.var, P - 1)


def felt_const(bld: CircuitBuilder, value: int) -> Felt:
    value = int(value) % P
    return Felt(bld.const(value), max(value, 1))


def _check_lt_p(bld: CircuitBuilder, v: Var):
    """v < p given v < 2^31: v + (2^24 - 1) still fits in 31 bits
    (p = 2^31 - 2^24 + 1)."""
    shifted = v.add_const((1 << 24) - 1)
    bld.bits_of(shifted, 31)


def fadd(a: Felt, b: Felt) -> Felt:
    out = Felt(a.var + b.var, a.bound + b.bound)
    return reduce(out) if out.bound >= _BOUND_LIMIT else out


def fsub(a: Felt, b: Felt) -> Felt:
    """a - b lifted non-negative: a + (kp - b) with kp >= b.bound."""
    k = (b.bound + P - 1) // P
    var = a.var.add_const(k * P) - b.var
    out = Felt(var, a.bound + k * P)
    return reduce(out) if out.bound >= _BOUND_LIMIT else out


def fmul(a: Felt, b: Felt) -> Felt:
    if a.bound * b.bound >= _BOUND_LIMIT:
        if a.bound >= b.bound:
            a = reduce(a)
        else:
            b = reduce(b)
        if a.bound * b.bound >= _BOUND_LIMIT:
            a, b = reduce(a), reduce(b)
    bld = a.bld if a.var.lc or not b.var.lc else b.bld
    out = bld.mul(a.var, b.var)
    return Felt(out, a.bound * b.bound)


def fscale(a: Felt, k: int) -> Felt:
    """Multiply by a small canonical constant (no constraint)."""
    assert 0 <= k < P
    out = Felt(a.var.scale(k), max(a.bound * k, 1))
    return reduce(out) if out.bound >= _BOUND_LIMIT else out


def reduce(a: Felt, canon: bool = False) -> Felt:
    """Hinted Euclidean division: a = q*p + r, q and r range-checked."""
    if a.bound < P and not canon:
        return a
    if canon and a.bound <= P - 1:
        return a
    bld = a.bld
    true_val = a.var.val  # exact integer (< bound < FR: no wrap happened)
    q_val, r_val = divmod(true_val, P)
    q = bld.wit(q_val)
    r = bld.wit(r_val)
    qbits = max((a.bound // P).bit_length(), 1)
    bld.bits_of(q, qbits)
    bld.bits_of(r, 31)
    if canon:
        _check_lt_p(bld, r)
    bld.assert_zero_var(a.var - q.scale(P) - r)
    return Felt(r, P - 1 if canon else (1 << 31) - 1)


def canon(a: Felt) -> Felt:
    return reduce(a, canon=True)


def assert_felt_eq(a: Felt, b: Felt):
    """a ≡ b (mod p): their lifted difference is an exact multiple of p."""
    d = fsub(a, b)  # non-negative, bound known
    bld = d.bld
    q_val, rem = divmod(d.var.val, P)
    assert rem == 0, f"assert_felt_eq on unequal values ({a.val} vs {b.val})"
    q = bld.wit(q_val)
    bld.bits_of(q, max((d.bound // P).bit_length(), 1))
    bld.assert_zero_var(d.var - q.scale(P))


def assert_felt_zero(a: Felt):
    assert_felt_eq(a, felt_const(a.bld, 0))


def felt_select(bit: Var, t: Felt, f: Felt) -> Felt:
    out = t.bld.select(bit, t.var, f.var)
    return Felt(out, max(t.bound, f.bound))


# -- degree-4 extension (x^4 = 3; core/ext.py) --------------------------------


class Ext:
    __slots__ = ("c",)

    def __init__(self, c):
        assert len(c) == _W
        self.c = list(c)

    @property
    def bld(self) -> CircuitBuilder:
        return self.c[0].bld

    @property
    def val(self):
        return [f.val for f in self.c]


def ext_wit(bld: CircuitBuilder, vals, canon_in: bool = True) -> Ext:
    return Ext([felt_wit(bld, int(v), canon=canon_in) for v in vals])


def ext_const(bld: CircuitBuilder, vals) -> Ext:
    return Ext([felt_const(bld, int(v)) for v in vals])


def ext_from_base(f: Felt) -> Ext:
    z = felt_const(f.bld, 0)
    return Ext([f, z, z, z])


def eadd(a: Ext, b: Ext) -> Ext:
    return Ext([fadd(x, y) for x, y in zip(a.c, b.c)])


def esub(a: Ext, b: Ext) -> Ext:
    return Ext([fsub(x, y) for x, y in zip(a.c, b.c)])


def _pair_mul(a0, a1, b0, b1):
    """(a0 + a1 x)(b0 + b1 x) via Karatsuba: 3 muls, result (z0, z1, z2)."""
    m0 = fmul(a0, b0)
    m1 = fmul(a1, b1)
    m2 = fmul(fadd(a0, a1), fadd(b0, b1))
    return m0, fsub(m2, fadd(m0, m1)), m1


def emul(a: Ext, b: Ext) -> Ext:
    """Two-level Karatsuba with x^4 = 3 wraparound: 9 wire muls (vs 16
    schoolbook) — fewer muls means fewer accumulated bound bits, which is
    what reduction range checks ultimately pay for."""
    a0, a1, a2, a3 = a.c
    b0, b1, b2, b3 = b.c
    c0, c1, c2 = _pair_mul(a0, a1, b0, b1)            # AC
    d0, d1, d2 = _pair_mul(a2, a3, b2, b3)            # BD
    e0, e1, e2 = _pair_mul(fadd(a0, a2), fadd(a1, a3),
                           fadd(b0, b2), fadd(b1, b3))  # (A+B)(C+D)
    # AD + BC = e - c - d; result = AC + (AD+BC) x^2 + BD x^4, x^4 -> 3
    m0 = fsub(e0, fadd(c0, d0))
    m1 = fsub(e1, fadd(c1, d1))
    m2 = fsub(e2, fadd(c2, d2))
    return Ext([
        fadd(c0, fscale(fadd(m2, d0), 3)),
        fadd(c1, fscale(d1, 3)),
        fadd(fadd(c2, m0), fscale(d2, 3)),
        m1,
    ])


def emul_base(a: Ext, f: Felt) -> Ext:
    return Ext([fmul(x, f) for x in a.c])


def ext_reduce(a: Ext, canon_out: bool = False) -> Ext:
    return Ext([reduce(x, canon=canon_out) for x in a.c])


def assert_ext_eq(a: Ext, b: Ext):
    for x, y in zip(a.c, b.c):
        assert_felt_eq(x, y)


def ext_select(bit: Var, t: Ext, f: Ext) -> Ext:
    return Ext([felt_select(bit, x, y) for x, y in zip(t.c, f.c)])


def einv_hinted(a: Ext, canon_in: bool = True) -> Ext:
    """Hint the extension inverse and constrain a * inv == 1
    (reference: the gnark circuit hints all inversions)."""
    from ..core import ext as E
    import numpy as np

    bld = a.bld
    vals = np.array([x.val for x in a.c], dtype=np.uint32)
    inv = E.einv(vals)
    out = ext_wit(bld, [int(v) for v in inv], canon_in=canon_in)
    one = ext_const(bld, [1, 0, 0, 0])
    assert_ext_eq(emul(a, out), one)
    return out


def finv_hinted(a: Felt) -> Felt:
    from ..core import field as F
    import numpy as np

    bld = a.bld
    inv = int(F.finv(np.uint32(a.val)))
    out = felt_wit(bld, inv)
    assert_felt_eq(fmul(a, out), felt_const(bld, 1))
    return out
