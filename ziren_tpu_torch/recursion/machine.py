"""The recursion machine: chips proving RecursionProgram instruction streams
on the generic STARK engine (reference: crates/recursion/core — redesigned
around the DSL's SSA property; see docs/recursion_design.md).

Register argument: the program is SSA (every register written exactly once),
so registers form a multiset — the writing row SENDS (reg, value) with the
register's static read count as multiplicity, and every reading row RECEIVES
(reg, value) once. Program structure (ops, register ids, read counts) is
PREPROCESSED, so the vk pins the program; only the values are witness.

Chips:
    Const     preprocessed (reg, val, mult) sends
    Input     pv-bound runtime inputs (reg from preprocessed, val = pv[slot])
    BaseAlu   add/sub/mul/inv/select/assert_eq rows (op one-hot preprocessed)
    ExtAlu    ext4 add/sub/mul/inv over 4-limb register windows
    Poseidon2 one permutation per row (22-round in-row chain)
    Output    receives (reg, val), binds val = pv[num_inputs + i]
"""

from __future__ import annotations

import numpy as np

from ..core import ext as E
from ..core import field as F
from ..machine.layout import Layout, pad_to_pow2
from ..machine.poseidon2_chip import (
    DIAG,
    M_EXT,
    NUM_ROUNDS,
    RC,
    _zero_chain,
)
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from ..stark.machine import StarkMachine

from .dsl import Op, RecursionProgram, interpret

P = F.P_INT
REG = LookupKind.Register


def _send(b, reg, val, mult):
    b.send(REG, [reg, val], mult)


def _recv(b, reg, val, mult):
    b.receive(REG, [reg, val], mult)


class _Compiled:
    """Per-chip row streams + static read counts for one program."""

    def __init__(self, program: RecursionProgram):
        self.program = program
        reads: dict[int, int] = {}

        def rd(r, k=1):
            for i in range(k):
                reads[r + i] = reads.get(r + i, 0) + 1

        self.const_rows = []   # (reg, val)
        self.input_rows = []   # (reg, slot)
        self.hint_rows = []    # (reg, slot)
        self.alu_rows = []     # (op, a, b, c, out)
        self.ext_rows = []     # (op, a, b, out, b_base)
        self.p2_rows = []      # (ids16, out)
        self.sel8_rows = []    # (cond, a_ids8, b_ids8, out)
        self.ffold_rows = []   # (acc, ap, alpha, ys, row, out)
        self.exprev_rows = []  # flat per-bit: (bit_id, factor, first, last, out, mult_slot)
        self.output_rows = []  # (reg, slot)
        n_out = 0
        for op, a, b, c, out in program.ops:
            if op == Op.CONST:
                self.const_rows.append((out, a))
            elif op == Op.INPUT:
                self.input_rows.append((out, a))
            elif op == Op.HINT:
                self.hint_rows.append((out, a))
            elif op in (Op.ADD, Op.SUB, Op.MUL):
                rd(a), rd(b)
                self.alu_rows.append((op, a, b, 0, out))
            elif op == Op.INV:
                rd(a)
                self.alu_rows.append((op, a, 0, 0, out))
            elif op == Op.SELECT:
                rd(a), rd(b), rd(c)
                self.alu_rows.append((op, a, b, c, out))
            elif op == Op.ASSERT_EQ:
                rd(a), rd(b)
                self.alu_rows.append((op, a, b, 0, 0))
            elif op in (Op.EADD, Op.ESUB, Op.EMUL):
                rd(a, 4), rd(b, 4)
                self.ext_rows.append((op, a, b, out, 0))
            elif op in (Op.EADDB, Op.ESUBB, Op.EMULB):
                rd(a, 4), rd(b)
                base_op = {Op.EADDB: Op.EADD, Op.ESUBB: Op.ESUB,
                           Op.EMULB: Op.EMUL}[op]
                self.ext_rows.append((base_op, a, b, out, 1))
            elif op == Op.EINV:
                rd(a, 4)
                self.ext_rows.append((op, a, 0, out, 0))
            elif op == Op.POSEIDON2:
                ids = program.p2_inputs[a]
                for r_id in ids:
                    rd(r_id)
                self.p2_rows.append((ids, out))
            elif op == Op.SELECT8:
                cond, a8, b8 = program.sel8_inputs[a]
                rd(cond)
                for r_id in a8:
                    rd(r_id)
                for r_id in b8:
                    rd(r_id)
                self.sel8_rows.append((cond, a8, b8, out))
            elif op == Op.FFOLD:
                acc, ap, alpha, ys, row = program.ffold_inputs[a]
                rd(acc, 4), rd(ap, 4), rd(alpha, 4), rd(ys, 4), rd(row)
                self.ffold_rows.append((acc, ap, alpha, ys, row, out))
            elif op == Op.EXPREV:
                bit_ids, factors = program.exprev_inputs[a]
                n_bits = len(bit_ids)
                for j, (r_id, f) in enumerate(zip(bit_ids, factors)):
                    rd(r_id)
                    self.exprev_rows.append(
                        (r_id, f, int(j == 0), int(j == n_bits - 1), out)
                    )
            elif op == Op.OUTPUT:
                rd(a)
                self.output_rows.append((a, n_out))
                n_out += 1
        self.num_outputs = n_out
        self.reads = reads

    def mult(self, reg: int) -> int:
        return self.reads.get(reg, 0)


class _RecAir(Air):
    # eval depends on per-program instance state (compiled rows, pv widths)
    # so the per-class symbolic metadata cache must not apply
    _no_meta_cache = True

    def __init__(self, compiled: _Compiled):
        self.c = compiled


def _writer_mult_cols(l: Layout, prefix: str, k: int):
    for i in range(k):
        l.add(f"{prefix}{i}")


class ConstChip(_RecAir):
    """8 constants per row (fully preprocessed; padding lanes mult=0)."""

    name = "RecConst"
    LANES = 8

    def __init__(self, compiled):
        super().__init__(compiled)
        self.rows = compiled.const_rows
        self.preprocessed_width = 3 * self.LANES

    width = 1  # engine requires a main trace; a single is_real column

    def generate_preprocessed(self, program):
        rows = self.rows
        n = max(1, -(-len(rows) // self.LANES))
        prep = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        for i, (reg, val) in enumerate(rows):
            r, k = divmod(i, self.LANES)
            prep[r, 3 * k : 3 * k + 3] = (reg, val, self.c.mult(reg))
        return pad_to_pow2(prep)

    def generate_trace(self, record, output):
        n = max(1, -(-len(self.rows) // self.LANES))
        return pad_to_pow2(np.ones((n, 1), dtype=np.uint32))

    def eval(self, b):
        for k in range(self.LANES):
            reg, val, mult = b.prep_local[3 * k : 3 * k + 3]
            _send(b, reg, val, mult)


class InputChip(_RecAir):
    name = "RecInput"

    def __init__(self, compiled):
        super().__init__(compiled)
        self.rows = compiled.input_rows
        self.preprocessed_width = 3 + max(
            1, compiled.program.num_inputs
        )  # reg, mult, + slot one-hot

    width = 1

    def generate_preprocessed(self, program):
        rows = self.rows
        ni = max(1, self.c.program.num_inputs)
        n = max(1, len(rows))
        prep = np.zeros((n, 3 + ni), dtype=np.uint32)
        for i, (reg, slot) in enumerate(rows):
            prep[i, 0] = reg
            prep[i, 1] = self.c.mult(reg)
            prep[i, 2] = 1  # is_real
            prep[i, 3 + slot] = 1
        return pad_to_pow2(prep)

    def generate_trace(self, record, output):
        rows = self.rows
        n = max(1, len(rows))
        mat = np.zeros((n, 1), dtype=np.uint32)
        for i, (reg, slot) in enumerate(rows):
            mat[i, 0] = record.inputs[slot]
        return pad_to_pow2(mat)

    def eval(self, b):
        prep = b.prep_local
        reg, mult, is_real = prep[0], prep[1], prep[2]
        (val,) = b.main_local
        ni = max(1, self.c.program.num_inputs)
        # val = pv[slot] via the preprocessed one-hot
        sel = 0
        for s in range(ni):
            sel = prep[3 + s] * b.public_values[s] + sel
        b.when(is_real).assert_eq(val, sel)
        _send(b, reg, val, mult)


class HintChip(_RecAir):
    """Unconstrained witness registers, 8 per row: value columns are free;
    the program's own constraints pin hints down (bit decompositions,
    Merkle paths). Padding lanes have mult=0."""

    name = "RecHint"
    LANES = 8

    def __init__(self, compiled):
        super().__init__(compiled)
        self.rows = compiled.hint_rows
        self.preprocessed_width = 2 * self.LANES

    width = 8

    def generate_preprocessed(self, program):
        rows = self.rows
        n = max(1, -(-len(rows) // self.LANES))
        prep = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        for i, (reg, slot) in enumerate(rows):
            r, k = divmod(i, self.LANES)
            prep[r, 2 * k : 2 * k + 2] = (reg, self.c.mult(reg))
        return pad_to_pow2(prep)

    def generate_trace(self, record, output):
        rows = self.rows
        n = max(1, -(-len(rows) // self.LANES))
        mat = np.zeros((n, self.width), dtype=np.uint32)
        regs = record.regs
        for i, (reg, slot) in enumerate(rows):
            r, k = divmod(i, self.LANES)
            mat[r, k] = regs[reg]
        return pad_to_pow2(mat)

    def eval(self, b):
        for k in range(self.LANES):
            reg, mult = b.prep_local[2 * k : 2 * k + 2]
            _send(b, reg, b.main_local[k], mult)


class OutputChip(_RecAir):
    name = "RecOutput"

    def __init__(self, compiled):
        super().__init__(compiled)
        self.rows = compiled.output_rows
        self.no = max(1, compiled.num_outputs)
        self.preprocessed_width = 2 + self.no

    width = 1

    def generate_preprocessed(self, program):
        rows = self.rows
        n = max(1, len(rows))
        prep = np.zeros((n, 2 + self.no), dtype=np.uint32)
        for i, (reg, slot) in enumerate(rows):
            prep[i, 0] = reg
            prep[i, 1] = 1
            prep[i, 2 + slot] = 1
        return pad_to_pow2(prep)

    def generate_trace(self, record, output):
        rows = self.rows
        n = max(1, len(rows))
        mat = np.zeros((n, 1), dtype=np.uint32)
        for i, (reg, slot) in enumerate(rows):
            mat[i, 0] = record.regs[reg]
        return pad_to_pow2(mat)

    def eval(self, b):
        prep = b.prep_local
        reg, is_real = prep[0], prep[1]
        (val,) = b.main_local
        ni = self.c.program.num_inputs
        if self.c.num_outputs:
            sel = 0
            for s in range(self.c.num_outputs):
                sel = prep[2 + s] * b.public_values[ni + s] + sel
            b.when(is_real).assert_eq(val, sel)
        _recv(b, reg, val, is_real)


class BaseAluChip(_RecAir):
    name = "RecBaseAlu"
    OPS = [Op.ADD, Op.SUB, Op.MUL, Op.INV, Op.SELECT, Op.ASSERT_EQ]

    def __init__(self, compiled):
        super().__init__(compiled)
        self.rows = compiled.alu_rows
        # preprocessed: op one-hot (6) + a,b,c,out regs + out mult + b_used,
        # c_used flags (receive multiplicities)
        self.preprocessed_width = 6 + 4 + 1 + 2

    width = 4  # va, vb, vc, vout

    def generate_preprocessed(self, program):
        rows = self.rows
        n = max(1, len(rows))
        prep = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        for i, (op, a, b_, c, out) in enumerate(rows):
            prep[i, self.OPS.index(op)] = 1
            prep[i, 6:10] = (a, b_, c, out)
            prep[i, 10] = self.c.mult(out) if op != Op.ASSERT_EQ else 0
            prep[i, 11] = int(op not in (Op.INV,))
            prep[i, 12] = int(op == Op.SELECT)
        return pad_to_pow2(prep)

    def generate_trace(self, record, output):
        rows = self.rows
        n = max(1, len(rows))
        mat = np.zeros((n, 4), dtype=np.uint32)
        regs = record.regs
        for i, (op, a, b_, c, out) in enumerate(rows):
            mat[i] = (regs[a], regs[b_], regs[c], regs[out] if op != Op.ASSERT_EQ else 0)
        return pad_to_pow2(mat)

    def eval(self, b):
        prep = b.prep_local
        f = {op: prep[j] for j, op in enumerate(self.OPS)}
        ra, rb, rc, rout = prep[6], prep[7], prep[8], prep[9]
        out_mult, b_used, c_used = prep[10], prep[11], prep[12]
        va, vb, vc, vout = b.main_local
        is_real = sum(f.values())
        _recv(b, ra, va, is_real)
        _recv(b, rb, vb, b_used)
        _recv(b, rc, vc, c_used)
        _send(b, rout, vout, out_mult)
        b.when(f[Op.ADD]).assert_eq(vout, va + vb)
        b.when(f[Op.SUB]).assert_eq(vout, va - vb)
        b.when(f[Op.MUL]).assert_eq(vout, va * vb)
        b.when(f[Op.INV]).assert_eq(va * vout, 1)
        b.when(f[Op.SELECT]).assert_zero(va * (1 - va))
        b.when(f[Op.SELECT]).assert_eq(vout, va * vb + (1 - va) * vc)
        b.when(f[Op.ASSERT_EQ]).assert_eq(va, vb)


class ExtAluChip(_RecAir):
    name = "RecExtAlu"
    OPS = [Op.EADD, Op.ESUB, Op.EMUL, Op.EINV]

    def __init__(self, compiled):
        super().__init__(compiled)
        self.rows = compiled.ext_rows
        # op one-hot (4) + a,b,out base regs + per-limb out mults (4)
        # + b_ext (full ext operand) + b_base ([b, 0, 0, 0] operand)
        self.preprocessed_width = 4 + 3 + 4 + 2

    width = 12  # va[4], vb[4], vout[4]

    def generate_preprocessed(self, program):
        rows = self.rows
        n = max(1, len(rows))
        prep = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        for i, (op, a, b_, out, b_base) in enumerate(rows):
            prep[i, self.OPS.index(op)] = 1
            prep[i, 4:7] = (a, b_, out)
            for k in range(4):
                prep[i, 7 + k] = self.c.mult(out + k)
            prep[i, 11] = int(op != Op.EINV and not b_base)
            prep[i, 12] = int(b_base)
        return pad_to_pow2(prep)

    def generate_trace(self, record, output):
        rows = self.rows
        n = max(1, len(rows))
        mat = np.zeros((n, 12), dtype=np.uint32)
        regs = record.regs
        for i, (op, a, b_, out, b_base) in enumerate(rows):
            mat[i, 0:4] = regs[a : a + 4]
            if b_base:
                mat[i, 4] = regs[b_]
            else:
                mat[i, 4:8] = regs[b_ : b_ + 4]
            mat[i, 8:12] = regs[out : out + 4]
        return pad_to_pow2(mat)

    def eval(self, b):
        prep = b.prep_local
        f = {op: prep[j] for j, op in enumerate(self.OPS)}
        ra, rb, rout = prep[4], prep[5], prep[6]
        va = b.main_local[0:4]
        vb = b.main_local[4:8]
        vo = b.main_local[8:12]
        is_real = sum(f.values())
        b_ext, b_base = prep[11], prep[12]
        for k in range(4):
            _recv(b, ra + k, va[k], is_real)
            _recv(b, rb + k, vb[k], b_ext)
            _send(b, rout + k, vo[k], prep[7 + k])
        # base-operand rows read ONE register into limb 0; high limbs 0
        _recv(b, rb, vb[0], b_base)
        for k in range(1, 4):
            b.assert_zero(b_base * vb[k])
        for k in range(4):
            b.when(f[Op.EADD]).assert_eq(vo[k], va[k] + vb[k])
            b.when(f[Op.ESUB]).assert_eq(vo[k], va[k] - vb[k])
        # schoolbook ext4 product with x^4 = 3 (shared by EMUL / EINV)
        def prod(x, y):
            c0 = x[0] * y[0] + 3 * (x[1] * y[3] + x[2] * y[2] + x[3] * y[1])
            c1 = x[0] * y[1] + x[1] * y[0] + 3 * (x[2] * y[3] + x[3] * y[2])
            c2 = x[0] * y[2] + x[1] * y[1] + x[2] * y[0] + 3 * (x[3] * y[3])
            c3 = x[0] * y[3] + x[1] * y[2] + x[2] * y[1] + x[3] * y[0]
            return (c0, c1, c2, c3)

        pm = prod(va, vb)
        po = prod(va, vo)
        for k in range(4):
            b.when(f[Op.EMUL]).assert_eq(vo[k], pm[k])
            b.when(f[Op.EINV]).assert_eq(po[k], 1 if k == 0 else 0)


class Select8Chip(_RecAir):
    """One row selects a whole 8-felt digest half: out[k] = cond ? a[k]
    : b[k] (Merkle path walks; replaces 8 BaseAlu SELECT rows)."""

    name = "RecSelect8"

    def __init__(self, compiled):
        super().__init__(compiled)
        self.rows = compiled.sel8_rows
        # cond id + 8 a ids + 8 b ids + out base + is_real + 8 out mults
        self.preprocessed_width = 1 + 8 + 8 + 1 + 1 + 8

    width = 1 + 8 + 8 + 8  # cond, a vals, b vals, out vals

    def generate_preprocessed(self, program):
        rows = self.rows
        n = max(1, len(rows))
        prep = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        for i, (cond, a8, b8, out) in enumerate(rows):
            prep[i, 0] = cond
            prep[i, 1:9] = a8
            prep[i, 9:17] = b8
            prep[i, 17] = out
            prep[i, 18] = 1
            for k in range(8):
                prep[i, 19 + k] = self.c.mult(out + k)
        return pad_to_pow2(prep)

    def generate_trace(self, record, output):
        rows = self.rows
        n = max(1, len(rows))
        mat = np.zeros((n, self.width), dtype=np.uint32)
        regs = record.regs
        for i, (cond, a8, b8, out) in enumerate(rows):
            mat[i, 0] = regs[cond]
            mat[i, 1:9] = regs[list(a8)]
            mat[i, 9:17] = regs[list(b8)]
            mat[i, 17:25] = regs[out : out + 8]
        return pad_to_pow2(mat)

    def eval(self, b):
        prep = b.prep_local
        rout, is_real = prep[17], prep[18]
        vc = b.main_local[0]
        va = b.main_local[1:9]
        vb = b.main_local[9:17]
        vo = b.main_local[17:25]
        b.assert_zero(vc * (vc - 1))  # padding rows are all-zero: holds
        _recv(b, prep[0], vc, is_real)
        for k in range(8):
            _recv(b, prep[1 + k], va[k], is_real)
            _recv(b, prep[9 + k], vb[k], is_real)
            _send(b, rout + k, vo[k], prep[19 + k])
            b.assert_zero(vo[k] - vb[k] - vc * (va[k] - vb[k]))


class FriFoldChip(_RecAir):
    """Fused FRI reduced-opening step (reference recursion FriFold chip):
    acc' = acc + ap * (ys - [row,0,0,0]), ap' = ap * alpha — one row
    instead of four ExtAlu rows per opened column."""

    name = "RecFriFold"

    def __init__(self, compiled):
        super().__init__(compiled)
        self.rows = compiled.ffold_rows
        # 5 input bases/ids + out base + is_real + 8 out mults
        self.preprocessed_width = 5 + 1 + 1 + 8

    width = 4 + 4 + 4 + 4 + 1 + 8  # acc, ap, alpha, ys, row, acc'|ap'

    def generate_preprocessed(self, program):
        rows = self.rows
        n = max(1, len(rows))
        prep = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        for i, (acc, ap, alpha, ys, row, out) in enumerate(rows):
            prep[i, 0:5] = (acc, ap, alpha, ys, row)
            prep[i, 5] = out
            prep[i, 6] = 1
            for k in range(8):
                prep[i, 7 + k] = self.c.mult(out + k)
        return pad_to_pow2(prep)

    def generate_trace(self, record, output):
        rows = self.rows
        n = max(1, len(rows))
        mat = np.zeros((n, self.width), dtype=np.uint32)
        regs = record.regs
        for i, (acc, ap, alpha, ys, row, out) in enumerate(rows):
            mat[i, 0:4] = regs[acc : acc + 4]
            mat[i, 4:8] = regs[ap : ap + 4]
            mat[i, 8:12] = regs[alpha : alpha + 4]
            mat[i, 12:16] = regs[ys : ys + 4]
            mat[i, 16] = regs[row]
            mat[i, 17:25] = regs[out : out + 8]
        return pad_to_pow2(mat)

    def eval(self, b):
        prep = b.prep_local
        rout, is_real = prep[5], prep[6]
        m = b.main_local
        acc, ap, alpha, ys = m[0:4], m[4:8], m[8:12], m[12:16]
        row = m[16]
        acc_o, ap_o = m[17:21], m[21:25]
        for k in range(4):
            _recv(b, prep[0] + k, acc[k], is_real)
            _recv(b, prep[1] + k, ap[k], is_real)
            _recv(b, prep[2] + k, alpha[k], is_real)
            _recv(b, prep[3] + k, ys[k], is_real)
            _send(b, rout + k, acc_o[k], prep[7 + k])
            _send(b, rout + 4 + k, ap_o[k], prep[7 + 4 + k])
        _recv(b, prep[4], row, is_real)

        def prod(x, y):
            c0 = x[0] * y[0] + 3 * (x[1] * y[3] + x[2] * y[2] + x[3] * y[1])
            c1 = x[0] * y[1] + x[1] * y[0] + 3 * (x[2] * y[3] + x[3] * y[2])
            c2 = x[0] * y[2] + x[1] * y[1] + x[2] * y[0] + 3 * (x[3] * y[3])
            c3 = x[0] * y[3] + x[1] * y[2] + x[2] * y[1] + x[3] * y[0]
            return (c0, c1, c2, c3)

        d = (ys[0] - row, ys[1], ys[2], ys[3])
        pd = prod(ap, d)
        pa = prod(ap, alpha)
        for k in range(4):
            b.assert_zero(acc_o[k] - acc[k] - pd[k])
            b.assert_zero(ap_o[k] - pa[k])


class ExpRevBitsChip(_RecAir):
    """g^reverse_bits(index) accumulator: ONE narrow row per index bit
    (reference: recursion ExpReverseBitsLen chip) instead of a select+mul
    BaseAlu chain per bit. Rows of one op chain acc through `chain`;
    the last row sends the product to the out register."""

    name = "RecExpRevBits"

    def __init__(self, compiled):
        super().__init__(compiled)
        self.rows = compiled.exprev_rows
        # bit_id, factor, is_first, chain, is_last, out_id, is_real, out_mult
        self.preprocessed_width = 8

    width = 3  # bit, step, acc

    def generate_preprocessed(self, program):
        rows = self.rows
        n = max(1, len(rows))
        prep = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        for i, (bit_id, factor, first, last, out) in enumerate(rows):
            prep[i, 0] = bit_id
            prep[i, 1] = factor
            prep[i, 2] = first
            prep[i, 3] = 1 - first  # chain: continues the previous row's op
            prep[i, 4] = last
            prep[i, 5] = out
            prep[i, 6] = 1
            prep[i, 7] = self.c.mult(out) if last else 0
        return pad_to_pow2(prep)

    def generate_trace(self, record, output):
        rows = self.rows
        n = max(1, len(rows))
        mat = np.zeros((n, self.width), dtype=np.uint32)
        regs = record.regs
        P = 2130706433
        acc = 1
        for i, (bit_id, factor, first, last, out) in enumerate(rows):
            bit = int(regs[bit_id])
            step = (1 + bit * (factor - 1)) % P
            acc = step if first else (acc * step) % P
            mat[i, 0] = bit
            mat[i, 1] = step
            mat[i, 2] = acc
        return pad_to_pow2(mat)

    def eval(self, b):
        prep = b.prep_local
        bit_id, factor = prep[0], prep[1]
        is_first, chain, is_last = prep[2], prep[3], prep[4]
        out_id, is_real, out_mult = prep[5], prep[6], prep[7]
        bit, step, acc = b.main_local[0], b.main_local[1], b.main_local[2]
        n_chain = b.prep_next[3]
        n_step = b.main_next[1]
        n_acc = b.main_next[2]

        b.when(is_real).assert_bool(bit)
        b.when(is_real).assert_eq(step, 1 + bit * (factor - 1))
        b.when(is_first).assert_eq(acc, step)
        # within an op: acc' = acc * step' (next row's chain flag gates it;
        # padding rows have chain = 0 so the boundary is inert)
        b.when_transition().when(n_chain).assert_eq(n_acc, acc * n_step)
        _recv(b, bit_id, bit, is_real)
        _send(b, out_id, acc, out_mult)


class RecPoseidon2Chip(_RecAir):
    name = "RecPoseidon2"

    def __init__(self, compiled):
        super().__init__(compiled)
        self.rows = compiled.p2_rows
        # 16 input reg ids, out reg base, is_real, per-limb out mults (16)
        # (reference: the recursion Poseidon2 instruction's 16 addrs)
        self.preprocessed_width = 16 + 2 + 16

    COLS = Layout()
    for r in range(NUM_ROUNDS + 2):
        COLS.add(f"s{r}", 16)
    width = COLS.width

    def generate_preprocessed(self, program):
        rows = self.rows
        n = max(1, len(rows))
        prep = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        for i, (ids, out) in enumerate(rows):
            for k in range(16):
                prep[i, k] = ids[k]
            prep[i, 16] = out
            prep[i, 17] = 1
            for k in range(16):
                prep[i, 18 + k] = self.c.mult(out + k)
        return pad_to_pow2(prep)

    def generate_trace(self, record, output):
        rows = self.rows
        n = max(1, len(rows))
        height = max(4, 1 << (n - 1).bit_length())
        mat = np.zeros((height, self.width), dtype=np.uint32)
        if rows:
            # batched over all permutation rows (int64: products < 2^62,
            # external-layer sums < 2^38 — bit-identical to the scalar path)
            regs = record.regs
            ids = np.array([list(i) for i, _ in rows], dtype=np.int64)
            me = np.asarray(M_EXT, dtype=np.int64)
            diag = np.asarray(DIAG, dtype=np.int64)
            rc = np.asarray(RC, dtype=np.int64)

            def ext(v):
                return (v % P) @ me.T % P

            def sbox(v):
                v = v % P
                return (v * v % P) * v % P

            s = regs[ids].astype(np.int64) % P
            states = [s]
            cur = ext(s)
            states.append(cur)
            for r in range(4):
                cur = ext(sbox(cur + rc[r][None, :]))
                states.append(cur)
            for r in range(13):
                t = cur.copy()
                t[:, 0] = sbox(cur[:, 0] + rc[4 + r][0])
                cur = (diag[None, :] * t
                       + t.sum(axis=1, keepdims=True) % P) % P
                states.append(cur)
            for r in range(4):
                cur = ext(sbox(cur + rc[17 + r][None, :]))
                states.append(cur)
            for r in range(NUM_ROUNDS + 2):
                mat[: len(rows), self.COLS.slc(f"s{r}")] = states[r] % P
        chain = _zero_chain()
        for r in range(NUM_ROUNDS + 2):
            # pad from the first non-real row (len(rows), NOT n: an empty
            # chip must fill row 0 with the valid chain too)
            mat[len(rows):, self.COLS.slc(f"s{r}")] = chain[r]
        return mat

    def eval(self, b):
        from ..machine.poseidon2_chip import Poseidon2PermuteChip as PC

        prep = b.prep_local
        rout, is_real = prep[16], prep[17]
        L = self.COLS.view(b.main_local)
        s0 = L["s0"]
        s_out = L[f"s{NUM_ROUNDS + 1}"]
        for k in range(16):
            _recv(b, prep[k], s0[k], is_real)
            _send(b, rout + k, s_out[k], prep[18 + k])
        PC._eval_rounds(PC, b, L, is_real)


class _Record:
    def __init__(self, inputs, regs):
        self.inputs = list(inputs)
        self.regs = regs
        self.public_values = None  # set by prove_recursion


def recursion_machine(program: RecursionProgram, config=None) -> tuple:
    """Build the per-shape machine for a program; returns (machine, compiled)."""
    from ..stark.config import dev_config

    comp = _Compiled(program)
    chips = [
        ConstChip(comp),
        InputChip(comp),
        HintChip(comp),
        BaseAluChip(comp),
        ExtAluChip(comp),
        Select8Chip(comp),
        FriFoldChip(comp),
        ExpRevBitsChip(comp),
        RecPoseidon2Chip(comp),
        OutputChip(comp),
    ]
    npv = program.num_inputs + comp.num_outputs
    machine = StarkMachine(config or dev_config(), chips, num_public_values=npv)
    return machine, comp


def prove_recursion(program: RecursionProgram, inputs=(), config=None,
                    hints=(), device=None):
    """Prove one DSL program execution; pv = inputs ++ outputs. `device`
    is StarkMachine.prove's: None is the GPU, a torch device runs the torch
    shard prover there, "host" is the numpy prover."""
    machine, comp = recursion_machine(program, config)
    pk, vk = machine.setup(program)
    outputs, regs = interpret(program, inputs, return_regs=True, hints=hints)
    record = _Record(inputs, regs)
    record.public_values = list(inputs) + list(outputs)
    proof = machine.prove(pk, [record], device=device)
    return machine, pk, vk, proof, outputs
