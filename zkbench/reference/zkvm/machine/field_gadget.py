"""Reusable byte-limb modular arithmetic gadgets over a FIXED modulus
(the moral equivalent of the reference's FieldOpCols<P> family,
crates/core/machine/src/operations/field/field_op.rs — redesigned around
this engine's degree-3 budget; see uint256.py for the runtime-modulus
variant).

All operands are little-endian byte-limb vectors of length NL (32 for
256-bit fields, 48 for bls12-381). Each gadget enforces a polynomial
identity at t = 256 with a committed carry polynomial whose limbs are
offset so they are non-negative, byte-range-checked via the byte table:

  mul:  a(t)*b(t) - r(t) - q(t)*m(t) = (t - 256) c(t),   q >= 0, 32/48 limbs
  lin:  sum_i s_i * x_i(t) - borrow*m(t) = (t - 256) c(t),  borrow in 0..3

Every per-coefficient equation stays far below p (< 2^25), so there is no
mod-p aliasing and the identities hold over the integers.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from .byte import count, send_byte

C_OFF = 1 << 15  # carry offset for mul carries (2 bytes)
C_OFF_LIN = 128  # carry offset for linear-op carries (1 byte)


def limbs_of(value: int, nl: int) -> list:
    return [(value >> (8 * i)) & 0xFF for i in range(nl)]


def pack_limbs(limbs) -> int:
    return sum(int(b) << (8 * i) for i, b in enumerate(limbs))


class ModMulGadget:
    """r = a*b mod m for constant modulus m. Columns: q (nl limbs) +
    carries (2*nl - 1 coefficients, two bytes each)."""

    def __init__(self, layout, prefix: str, modulus: int, nl: int):
        self.prefix = prefix
        self.m = modulus
        self.nl = nl
        self.nc = 2 * nl - 1
        layout.add(f"{prefix}_q", nl)
        layout.add(f"{prefix}_clo", self.nc).add(f"{prefix}_chi", self.nc)

    def witness(self, a: int, b: int, r: int):
        nl, nc = self.nl, self.nc
        q_int = (a * b - r) // self.m
        assert 0 <= q_int < (1 << (8 * nl)), "mul quotient out of range"
        assert (a * b - r) % self.m == 0
        al, bl = limbs_of(a, nl), limbs_of(b, nl)
        rl, ql = limbs_of(r, nl), limbs_of(q_int, nl)
        ml = limbs_of(self.m, nl)
        e = [0] * (nc + 1)
        for i in range(nl):
            for j in range(nl):
                e[i + j] += al[i] * bl[j] - ql[i] * ml[j]
        for k in range(nl):
            e[k] -= rl[k]
        carries, c_prev = [], 0
        for k in range(nc):
            tot = e[k] + c_prev
            assert tot % 256 == 0
            c = tot // 256
            assert -C_OFF <= c < C_OFF, c
            carries.append(c)
            c_prev = c
        assert e[nc] + c_prev == 0
        return ql, carries

    def fill(self, row, layout, a: int, b: int, r: int, record=None):
        ql, carries = self.witness(a, b, r)
        row[layout.slc(f"{self.prefix}_q")] = ql
        cw = np.array(carries) + C_OFF
        row[layout.slc(f"{self.prefix}_clo")] = cw & 0xFF
        row[layout.slc(f"{self.prefix}_chi")] = cw >> 8
        if record is not None:
            for k in range(0, self.nl - 1, 2):
                count(record, B.U8Range, np.array([ql[k]]), ql[k + 1])
            if self.nl % 2:
                count(record, B.U8Range, np.array([ql[self.nl - 1]]), 0)
            for c in carries:
                v = c + C_OFF
                count(record, B.U8Range, np.array([v & 0xFF]), v >> 8)

    def fill_padding(self, mat, layout, start):
        mat[start:, layout.slc(f"{self.prefix}_clo")] = C_OFF & 0xFF
        mat[start:, layout.slc(f"{self.prefix}_chi")] = C_OFF >> 8

    def eval(self, b_, L, a_limbs, b_limbs, r_limbs, is_real, gate=None):
        """Constraints. Without `gate` the identity is ungated (padding rows
        satisfy with zeros); pass gate=is_real when any term has a nonzero
        constant (raises each coefficient constraint by one degree)."""
        nl, nc = self.nl, self.nc
        q = L[f"{self.prefix}_q"]
        clo = L[f"{self.prefix}_clo"]
        chi = L[f"{self.prefix}_chi"]
        ml = limbs_of(self.m, nl)
        for k in range(0, nl - 1, 2):
            send_byte(b_, B.U8Range, q[k], q[k + 1], 0, is_real)
        if nl % 2:
            send_byte(b_, B.U8Range, q[nl - 1], 0, 0, is_real)
        for k in range(nc):
            send_byte(b_, B.U8Range, clo[k], chi[k], 0, is_real)
        carries = [clo[k] + chi[k] * 256 - C_OFF for k in range(nc)]
        for k in range(nc + 1):
            e = 0
            for i in range(max(0, k - nl + 1), min(nl, k + 1)):
                e = e + a_limbs[i] * b_limbs[k - i]
                if ml[k - i]:
                    e = e - q[i] * ml[k - i]
            if k < nl:
                e = e - r_limbs[k]
            c_prev = carries[k - 1] if k > 0 else 0
            c_cur = carries[k] if k < nc else 0
            expr = e + c_prev - c_cur * 256
            b_.assert_zero(gate * expr if gate is not None else expr)


class ModLinGadget:
    """sum_i s_i*x_i = borrow*m  (mod nothing — an exact integer identity
    with the carry poly), for small signed coefficients s_i. Used for
    r = a - b mod m  as  r + b - a - borrow*m = 0  etc. Columns: borrow +
    carries (nl coefficients, one offset byte each)."""

    def __init__(self, layout, prefix: str, modulus: int, nl: int,
                 max_borrow: int = 1):
        self.prefix = prefix
        self.m = modulus
        self.nl = nl
        self.max_borrow = max_borrow
        assert max_borrow <= 3  # borrow committed as two bits
        layout.add(f"{prefix}_b0").add(f"{prefix}_b1")
        layout.add(f"{prefix}_c", nl)

    def witness(self, terms):
        """terms: [(coef, value_int)]. Returns (borrow, carries)."""
        nl = self.nl
        total = sum(c * v for c, v in terms)
        assert total % self.m == 0, "linear identity does not hold"
        borrow = total // self.m
        assert 0 <= borrow <= self.max_borrow, borrow
        ml = limbs_of(self.m, nl)
        e = [0] * (nl + 1)
        for coef, v in terms:
            vl = limbs_of(v, nl)
            for k in range(nl):
                e[k] += coef * vl[k]
        for k in range(nl):
            e[k] -= borrow * ml[k]
        carries, c_prev = [], 0
        for k in range(nl):
            tot = e[k] + c_prev
            assert tot % 256 == 0
            c = tot // 256
            assert -C_OFF_LIN <= c < C_OFF_LIN, c
            carries.append(c)
            c_prev = c
        assert e[nl] + c_prev == 0
        return borrow, carries

    def fill(self, row, layout, terms, record=None):
        borrow, carries = self.witness(terms)
        row[layout.idx(f"{self.prefix}_b0")] = borrow & 1
        row[layout.idx(f"{self.prefix}_b1")] = borrow >> 1
        row[layout.slc(f"{self.prefix}_c")] = np.array(carries) + C_OFF_LIN
        if record is not None:
            cs = [c + C_OFF_LIN for c in carries]
            for k in range(0, self.nl - 1, 2):
                count(record, B.U8Range, np.array([cs[k]]), cs[k + 1])
            if self.nl % 2:
                count(record, B.U8Range, np.array([cs[self.nl - 1]]), 0)
        return borrow

    def fill_padding(self, mat, layout, start):
        mat[start:, layout.slc(f"{self.prefix}_c")] = C_OFF_LIN

    def eval(self, b_, L, terms, is_real, gate=None):
        """terms: [(coef, limb_list)]; coefs are small Python ints. Pass
        gate=is_real when any term is a nonzero constant vector."""
        nl = self.nl
        b0 = L[f"{self.prefix}_b0"]
        b1 = L[f"{self.prefix}_b1"]
        c_cols = L[f"{self.prefix}_c"]
        ml = limbs_of(self.m, nl)
        b_.assert_bool(b0)
        b_.assert_bool(b1)
        if self.max_borrow < 2:
            b_.assert_zero(b1)
        borrow = b0 + 2 * b1
        for k in range(0, nl - 1, 2):
            send_byte(b_, B.U8Range, c_cols[k], c_cols[k + 1], 0, is_real)
        if nl % 2:
            send_byte(b_, B.U8Range, c_cols[nl - 1], 0, 0, is_real)
        carries = [c_cols[k] - C_OFF_LIN for k in range(nl)]
        for k in range(nl + 1):
            e = 0
            for coef, limbs in terms:
                if k < nl:
                    e = e + coef * limbs[k]
            if k < nl and ml[k]:
                e = e - borrow * ml[k]
            c_prev = carries[k - 1] if k > 0 else 0
            c_cur = carries[k] if k < nl else 0
            expr = e + c_prev - c_cur * 256
            b_.assert_zero(gate * expr if gate is not None else expr)
