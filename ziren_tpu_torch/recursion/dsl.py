"""Recursion DSL: a Python tracer that records straight-line field programs
(reference: crates/recursion/compiler — `Felt`/`Ext` value DSL compiled to
recursion-VM instructions; see docs/recursion_design.md).

The verifier is written once against `Felt`/`Ext` handles; tracing it emits
a columnar instruction stream that (round 2) the recursion chip set proves.
`interpret` is the host oracle: it executes the stream over numpy and is the
differential reference for both the tracer and the future chips.

Ops (SoA: op, a, b, out; Poseidon2 uses 16-wide register windows):
    CONST            out <- imm
    ADD/SUB/MUL/INV  felt arithmetic mod p
    EADD/ESUB/EMUL/EINV  ext4 arithmetic (handles are 4 consecutive regs)
    POSEIDON2        regs[out:out+16] <- perm(regs[a:a+16])
    SELECT           out <- b if regs[cond] else c   (cond boolean felt)
    ASSERT_EQ        constrain regs[a] == regs[b]
    INPUT            out <- runtime input vector slot a
    OUTPUT           append regs[a] to the output stream
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from ..core import ext as E
from ..core import field as F
from ..core import poseidon2 as p2

P = F.P_INT


# -- pure-int ext4 arithmetic (x^4 = 3) -------------------------------------
# The tracer evaluates every op inline as python ints; routing 4-element ops
# through numpy cost ~90us each in per-call overhead (the lift hot loop runs
# ~100k of them). These mirror core/ext.py exactly over int 4-lists.


def _pemul(a, b):
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    return [
        (a0 * b0 + 3 * (a1 * b3 + a2 * b2 + a3 * b1)) % P,
        (a0 * b1 + a1 * b0 + 3 * (a2 * b3 + a3 * b2)) % P,
        (a0 * b2 + a1 * b1 + a2 * b0 + 3 * a3 * b3) % P,
        (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % P,
    ]


_PGAMMA = pow(3, (P - 1) // 4, P)
_PFROB = [
    [pow(pow(_PGAMMA, k, P), i, P) for i in range(4)] for k in range(4)
]


def _peinv(a):
    def frob(x, k):
        g = _PFROB[k]
        return [x[i] * g[i] % P for i in range(4)]

    b = _pemul(frob(a, 1), frob(a, 2))
    b = _pemul(b, frob(a, 3))
    n0 = _pemul(a, b)[0]
    inv = pow(n0, P - 2, P)
    return [x * inv % P for x in b]


def _p2_single(vals16):
    """One Poseidon2 permutation over int lists (native C when available)."""
    from ..core import p2_native

    if p2_native.available():
        st = np.array(vals16, dtype=np.uint32).reshape(1, 16)
        return [int(x) for x in p2_native.permute(st)[0]]
    return [int(x) for x in p2.permute(np.array(vals16, dtype=np.uint32))]


class Op(IntEnum):
    CONST = 0
    ADD = 1
    SUB = 2
    MUL = 3
    INV = 4
    EADD = 5
    ESUB = 6
    EMUL = 7
    EINV = 8
    POSEIDON2 = 9
    SELECT = 10
    ASSERT_EQ = 11
    INPUT = 12
    OUTPUT = 13
    HINT = 14
    # ext-alu with a BASE second operand ([b, 0, 0, 0]): kills the 4-copy
    # ext_from packing that dominated lift op counts
    EADDB = 15
    ESUBB = 16
    EMULB = 17
    # 8-wide digest select (Merkle path walks): one row selects a whole
    # digest half instead of 8 BaseAlu SELECT rows
    SELECT8 = 18
    # fused FRI reduced-opening step (reference FriFold chip):
    # acc' = acc + ap * (ys - [row,0,0,0]);  ap' = ap * alpha
    FFOLD = 19
    # out = prod_j (bit_j ? factor_j : 1) — g^reverse_bits(index) in one
    # chip-row per bit (reference recursion ExpReverseBitsLen chip)
    EXPREV = 20


@dataclass
class RecursionProgram:
    ops: list  # (op, a, b, c, out)
    num_regs: int
    num_inputs: int
    num_hints: int = 0
    # POSEIDON2 ops take 16 ARBITRARY input registers (reference: the
    # recursion Poseidon2 instruction's 16 addrs); op.a indexes this table
    p2_inputs: tuple = ()
    # SELECT8 ops: (cond_reg, a_ids8, b_ids8); op.a indexes this table
    sel8_inputs: tuple = ()
    # FFOLD ops: (acc_base, ap_base, alpha_base, ys_base, row_id)
    ffold_inputs: tuple = ()
    # EXPREV ops: (bit_ids tuple, factor_consts tuple); op.a indexes this
    exprev_inputs: tuple = ()


class Felt:
    __slots__ = ("r", "t")

    def __init__(self, tracer, reg):
        self.t = tracer
        self.r = reg

    def __add__(self, o):
        return self.t._bin(Op.ADD, self, self.t.lift(o))

    __radd__ = __add__

    def __sub__(self, o):
        return self.t._bin(Op.SUB, self, self.t.lift(o))

    def __rsub__(self, o):
        return self.t._bin(Op.SUB, self.t.lift(o), self)

    def __mul__(self, o):
        return self.t._bin(Op.MUL, self, self.t.lift(o))

    __rmul__ = __mul__

    def inv(self):
        out = self.t._reg()
        self.t._emit((Op.INV, self.r, 0, 0, out))
        return Felt(self.t, out)


class Ext:
    """Handle to 4 consecutive registers (ext4 coefficients). Binary ops
    accept a Felt operand directly (base-operand ALU rows) — no packing."""

    __slots__ = ("r", "t")

    def __init__(self, tracer, reg):
        self.t = tracer
        self.r = reg

    def _bin(self, op, o):
        out = self.t._reg(4)
        self.t._emit((op, self.r, o.r, 0, out))
        return Ext(self.t, out)

    def __add__(self, o):
        if isinstance(o, Felt):
            return self._bin(Op.EADDB, o)
        return self._bin(Op.EADD, o)

    def __sub__(self, o):
        if isinstance(o, Felt):
            return self._bin(Op.ESUBB, o)
        return self._bin(Op.ESUB, o)

    def __mul__(self, o):
        if isinstance(o, Felt):
            return self._bin(Op.EMULB, o)
        return self._bin(Op.EMUL, o)

    def inv(self):
        out = self.t._reg(4)
        self.t._emit((Op.EINV, self.r, 0, 0, out))
        return Ext(self.t, out)


class Tracer:
    """Records ops AND evaluates them concretely as it goes (when
    input_values are supplied), so witness hints — which depend on runtime
    values like sampled challenges — can be generated inline during tracing
    (the reference compiler's witness-stream generation)."""

    def __init__(self, num_inputs: int = 0, input_values=None,
                 phantom: bool = False):
        self.ops: list = []
        self.n = 0
        self.num_inputs = num_inputs
        self.num_hints = 0
        self.p2_inputs: list = []
        self.sel8_inputs: list = []
        self.ffold_inputs: list = []
        self.exprev_inputs: list = []
        self.hint_values: list = []
        self.input_values = (
            [int(v) % P for v in input_values] if input_values is not None
            else None
        )
        self.vals: list = []
        # phantom tracing: no concrete evaluation, but host-side helpers
        # that peek at values (septic hint points, bit decompositions) get
        # distinct per-register pseudo-values so structure-preserving
        # assertions (e.g. "the two added points differ") hold. Used to
        # enumerate recursion programs/vks for shapes with NO real proof
        # (reference prover/src/shapes.rs build_vk_map).
        self.phantom = phantom

    def _emit(self, op_tuple):
        self.ops.append(op_tuple)
        if self.input_values is None:
            return
        op, a, b, c, dst = op_tuple
        v = self.vals
        while len(v) < self.n:
            v.append(0)
        if op == Op.CONST:
            v[dst] = a
        elif op == Op.ADD:
            v[dst] = (v[a] + v[b]) % P
        elif op == Op.SUB:
            v[dst] = (v[a] - v[b]) % P
        elif op == Op.MUL:
            v[dst] = (v[a] * v[b]) % P
        elif op == Op.INV:
            v[dst] = pow(v[a], P - 2, P)
        elif op == Op.EADD:
            v[dst : dst + 4] = [(x + y) % P for x, y in
                                zip(v[a : a + 4], v[b : b + 4])]
        elif op == Op.ESUB:
            v[dst : dst + 4] = [(x - y) % P for x, y in
                                zip(v[a : a + 4], v[b : b + 4])]
        elif op == Op.EMUL:
            v[dst : dst + 4] = _pemul(v[a : a + 4], v[b : b + 4])
        elif op == Op.EADDB:
            v[dst] = (v[a] + v[b]) % P
            v[dst + 1 : dst + 4] = v[a + 1 : a + 4]
        elif op == Op.ESUBB:
            v[dst] = (v[a] - v[b]) % P
            v[dst + 1 : dst + 4] = v[a + 1 : a + 4]
        elif op == Op.EMULB:
            s = v[b]
            v[dst : dst + 4] = [x * s % P for x in v[a : a + 4]]
        elif op == Op.EINV:
            v[dst : dst + 4] = _peinv(v[a : a + 4])
        elif op == Op.POSEIDON2:
            ids = self.p2_inputs[a]
            v[dst : dst + 16] = _p2_single([v[i] for i in ids])
        elif op == Op.SELECT8:
            cond, a8, b8 = self.sel8_inputs[a]
            src = a8 if v[cond] else b8
            for k in range(8):
                v[dst + k] = v[src[k]]
        elif op == Op.FFOLD:
            acc, ap, alpha, ys, row = self.ffold_inputs[a]
            pv_ = v[ap : ap + 4]
            d = list(v[ys : ys + 4])
            d[0] = (d[0] - v[row]) % P
            pd = _pemul(pv_, d)
            v[dst : dst + 4] = [(x + y) % P for x, y in
                                zip(v[acc : acc + 4], pd)]
            v[dst + 4 : dst + 8] = _pemul(pv_, v[alpha : alpha + 4])
        elif op == Op.EXPREV:
            bit_ids, factors = self.exprev_inputs[a]
            acc = 1
            for r_id, f in zip(bit_ids, factors):
                if v[r_id]:
                    acc = (acc * f) % P
            v[dst] = acc
        elif op == Op.SELECT:
            v[dst] = v[b] if v[a] else v[c]
        elif op == Op.ASSERT_EQ:
            assert v[a] == v[b], f"trace-time assert_eq: {v[a]} != {v[b]}"
        elif op == Op.INPUT:
            v[dst] = self.input_values[a]
        elif op == Op.HINT:
            v[dst] = self.hint_values[a]

    def value(self, f) -> int:
        """Concrete value of a Felt (input_values tracing), a per-register
        pseudo-value (phantom tracing), or 0."""
        if self.input_values is not None:
            return self.vals[f.r]
        if self.phantom:
            return (f.r * 0x9E3779B1 + 0x6A09E667) % P
        return 0

    def _reg(self, k: int = 1) -> int:
        r = self.n
        self.n += k
        return r

    def lift(self, v):
        if isinstance(v, Felt):
            return v
        return self.const(int(v) % P)

    def const(self, v: int) -> Felt:
        """Constants are pure: one register per distinct value (the lift
        traces used to mint ~37k CONST rows, mostly repeats)."""
        v = int(v) % P
        cache = getattr(self, "_const_cache", None)
        if cache is None:
            cache = self._const_cache = {}
        f = cache.get(v)
        if f is not None:
            return f
        out = self._reg()
        self._emit((Op.CONST, v, 0, 0, out))
        f = Felt(self, out)
        cache[v] = f
        return f

    def ext_const(self, coeffs) -> Ext:
        out = self._reg(4)
        for i, c in enumerate(np.asarray(coeffs, np.uint32)):
            self._emit((Op.CONST, int(c), 0, 0, out + i))
        return Ext(self, out)

    def ext_from(self, felts) -> Ext:
        """Pack 4 Felt handles into an Ext (copies into a fresh window)."""
        out = self._reg(4)
        zero = None
        for i, f in enumerate(felts):
            self._emit((Op.ADD, f.r, self._zero().r, 0, out + i))
        return Ext(self, out)

    def _zero(self):
        z = getattr(self, "_z", None)
        if z is None:
            z = self._z = self.const(0)
        return z

    def _bin(self, op, a, b) -> Felt:
        out = self._reg()
        self._emit((op, a.r, b.r, 0, out))
        return Felt(self, out)

    def input(self, slot: int) -> Felt:
        out = self._reg()
        self._emit((Op.INPUT, slot, 0, 0, out))
        return Felt(self, out)

    def hint(self, value: int = 0) -> Felt:
        """Unconstrained witness value supplied at proving time; callers
        must pin it down with constraints (reference: compiler hint ops).
        When tracing concretely, `value` is recorded as the hint stream."""
        out = self._reg()
        self.hint_values.append(int(value) % P)
        self._emit((Op.HINT, self.num_hints, 0, 0, out))
        self.num_hints += 1
        return Felt(self, out)

    def poseidon2(self, state16) -> list:
        """state16: 16 Felt handles at ARBITRARY registers — the op carries
        their ids (no staging copies; reference Poseidon2 instr 16 addrs)."""
        idx = len(self.p2_inputs)
        self.p2_inputs.append(tuple(f.r for f in state16))
        out = self._reg(16)
        self._emit((Op.POSEIDON2, idx, 0, 0, out))
        return [Felt(self, out + i) for i in range(16)]

    def select(self, cond: Felt, a: Felt, b: Felt) -> Felt:
        out = self._reg()
        self._emit((Op.SELECT, cond.r, a.r, b.r, out))
        return Felt(self, out)

    def fri_fold_step(self, acc: Ext, ap: Ext, alpha: Ext, ys: Ext,
                      row: Felt):
        """(acc + ap*(ys - row), ap*alpha) as ONE FriFold row."""
        idx = len(self.ffold_inputs)
        self.ffold_inputs.append((acc.r, ap.r, alpha.r, ys.r, row.r))
        out = self._reg(8)
        self._emit((Op.FFOLD, idx, 0, 0, out))
        return Ext(self, out), Ext(self, out + 4)

    def exp_rev_bits(self, base: int, bits, reverse: bool = True) -> Felt:
        """prod_j (bit_j ? base^(2^k_j) : 1) with k_j = n-1-j (reverse) or
        j — one ExpRevBits chip row per bit instead of a select+mul ALU
        chain (reference recursion ExpReverseBitsLen)."""
        from ..core import field as F

        n = len(bits)
        factors = tuple(
            pow(int(base), 1 << ((n - 1 - j) if reverse else j), F.P_INT)
            for j in range(n)
        )
        idx = len(self.exprev_inputs)
        self.exprev_inputs.append((tuple(f.r for f in bits), factors))
        out = self._reg()
        self._emit((Op.EXPREV, idx, 0, 0, out))
        return Felt(self, out)

    def select8(self, cond: Felt, a8, b8) -> list:
        """out[k] = a8[k] if cond else b8[k], as ONE Select8 row."""
        idx = len(self.sel8_inputs)
        self.sel8_inputs.append(
            (cond.r, tuple(f.r for f in a8), tuple(f.r for f in b8))
        )
        out = self._reg(8)
        self._emit((Op.SELECT8, idx, 0, 0, out))
        return [Felt(self, out + k) for k in range(8)]

    def assert_eq(self, a: Felt, b: Felt):
        self._emit((Op.ASSERT_EQ, a.r, self.lift(b).r, 0, 0))

    def output(self, f: Felt):
        self._emit((Op.OUTPUT, f.r, 0, 0, 0))

    def program(self) -> RecursionProgram:
        return RecursionProgram(
            list(self.ops), self.n, self.num_inputs, self.num_hints,
            p2_inputs=tuple(self.p2_inputs),
            sel8_inputs=tuple(self.sel8_inputs),
            ffold_inputs=tuple(self.ffold_inputs),
            exprev_inputs=tuple(self.exprev_inputs),
        )


def interpret(program: RecursionProgram, inputs=(), return_regs=False,
              hints=()):
    """Host oracle: run the instruction stream, return the output values
    (and the full register file when return_regs — used by trace gen)."""
    regs = np.zeros(max(program.num_regs, 1), dtype=np.uint32)
    inputs = np.asarray(list(inputs), dtype=np.uint32)
    hints = list(hints)
    out = []
    for op, a, b, c, dst in program.ops:
        if op == Op.CONST:
            regs[dst] = a
        elif op == Op.ADD:
            regs[dst] = (int(regs[a]) + int(regs[b])) % P
        elif op == Op.SUB:
            regs[dst] = (int(regs[a]) - int(regs[b])) % P
        elif op == Op.MUL:
            regs[dst] = (int(regs[a]) * int(regs[b])) % P
        elif op == Op.INV:
            regs[dst] = pow(int(regs[a]), P - 2, P)
        elif op == Op.EADD:
            regs[dst : dst + 4] = E.eadd(regs[a : a + 4], regs[b : b + 4])
        elif op == Op.ESUB:
            regs[dst : dst + 4] = E.esub(regs[a : a + 4], regs[b : b + 4])
        elif op == Op.EMUL:
            regs[dst : dst + 4] = E.emul(regs[a : a + 4], regs[b : b + 4])
        elif op == Op.EADDB:
            y = np.array([regs[b], 0, 0, 0], dtype=np.uint32)
            regs[dst : dst + 4] = E.eadd(regs[a : a + 4], y)
        elif op == Op.ESUBB:
            y = np.array([regs[b], 0, 0, 0], dtype=np.uint32)
            regs[dst : dst + 4] = E.esub(regs[a : a + 4], y)
        elif op == Op.EMULB:
            y = np.array([regs[b], 0, 0, 0], dtype=np.uint32)
            regs[dst : dst + 4] = E.emul(regs[a : a + 4], y)
        elif op == Op.EINV:
            regs[dst : dst + 4] = E.einv(regs[a : a + 4])
        elif op == Op.POSEIDON2:
            ids = list(program.p2_inputs[a])
            regs[dst : dst + 16] = p2.permute(regs[ids])
        elif op == Op.SELECT8:
            cond, a8, b8 = program.sel8_inputs[a]
            src_ids = list(a8) if regs[cond] else list(b8)
            regs[dst : dst + 8] = regs[src_ids]
        elif op == Op.FFOLD:
            acc, ap, alpha, ys, row = program.ffold_inputs[a]
            d = E.esub(regs[ys : ys + 4],
                       np.array([regs[row], 0, 0, 0], dtype=np.uint32))
            regs[dst : dst + 4] = E.eadd(
                regs[acc : acc + 4], E.emul(regs[ap : ap + 4], d))
            regs[dst + 4 : dst + 8] = E.emul(
                regs[ap : ap + 4], regs[alpha : alpha + 4])
        elif op == Op.EXPREV:
            bit_ids, factors = program.exprev_inputs[a]
            acc = 1
            for r_id, f in zip(bit_ids, factors):
                if regs[r_id]:
                    acc = (acc * f) % P
            regs[dst] = acc
        elif op == Op.SELECT:
            regs[dst] = regs[b] if regs[a] else regs[c]
        elif op == Op.ASSERT_EQ:
            assert regs[a] == regs[b], f"assert_eq failed: {regs[a]} != {regs[b]}"
        elif op == Op.INPUT:
            regs[dst] = inputs[a]
        elif op == Op.HINT:
            regs[dst] = int(hints[a]) % P
        elif op == Op.OUTPUT:
            out.append(int(regs[a]))
    if return_regs:
        return out, regs
    return out


class TracedChallenger:
    """The duplex challenger written against the DSL (the Fiat-Shamir core
    of the recursion verifier; mirrors core/challenger.py observe/sample)."""

    def __init__(self, tracer: Tracer):
        self.t = tracer
        self.state = [tracer.const(0) for _ in range(16)]
        self.input_buffer: list = []
        self.output_buffer: list = []

    def observe(self, f: Felt):
        self.output_buffer = []
        self.input_buffer.append(f)
        if len(self.input_buffer) == 8:
            self._duplex()

    def _duplex(self):
        for i, f in enumerate(self.input_buffer):
            self.state[i] = f
        self.input_buffer = []
        self.state = self.t.poseidon2(self.state)
        self.output_buffer = list(self.state[:8])

    def sample(self) -> Felt:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def sample_ext(self) -> list:
        return [self.sample() for _ in range(4)]

    def sample_bits_list(self, nb: int) -> list:
        """nb low-bit handles of a sample, via a hinted CANONICAL 31-bit
        decomposition (if bits 30..24 are all set the low 24 must be zero,
        so values never alias mod p = 2^31 - 2^24 + 1). When tracing
        concretely the bit hints are generated inline."""
        t = self.t
        s = self.sample()
        s_val = t.value(s)
        bits = [t.hint((s_val >> i) & 1) for i in range(31)]
        acc = t.const(0)
        for i, bit in enumerate(bits):
            t.assert_eq(bit * bit, bit)
            acc = acc + bit * (1 << i)
        t.assert_eq(acc, s)
        top = t.const(1)
        for i in range(24, 31):
            top = top * bits[i]
        low_sum = t.const(0)
        for i in range(24):
            low_sum = low_sum + bits[i]
        t.assert_eq(top * low_sum, t.const(0))
        return bits[:nb]

    def sample_bits(self, nb: int) -> Felt:
        bits = self.sample_bits_list(nb)
        t = self.t
        out = t.const(0)
        for i, bit in enumerate(bits):
            out = out + bit * (1 << i)
        return out
