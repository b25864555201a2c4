"""Shift chips: ShiftLeftChip (SLL) and ShiftRightChip (SRL/SRA/ROR)
(reference: crates/core/machine/src/alu/sll, alu/sr).

Both use the two-stage decomposition: a bit shift by (c % 8) with byte-level
carries, then a byte rotation by (c / 8) % 4 selected with one-hot flags.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import Opcode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .layout import Layout, pad_to_pow2, word_decompose_np
from .messages import instruction_message
from .synthetic import count_rows, merged_rows


def _bits_layout(l: Layout) -> Layout:
    l.add("cb", 5)  # low 5 bits of c[0] (shift amount)
    l.add("ch", 3)  # high 3 bits of c[0]
    l.add("bs", 4)  # one-hot byte-shift amount
    l.add("m1")  # 2^(c % 8)
    return l


def _rows(record, opcodes):
    rows, _ = merged_rows(record, opcodes)
    return rows


def _fill_bits(w, c_vals, n):
    c0 = c_vals & 0xFF
    bits = np.zeros((n, 5), dtype=np.uint32)
    for i in range(5):
        bits[:, i] = (c0 >> i) & 1
    w.set("cb", bits)
    ch = np.zeros((n, 3), dtype=np.uint32)
    for i in range(3):
        ch[:, i] = (c0 >> (5 + i)) & 1
    w.set("ch", ch)
    nbytes = (c0 >> 3) & 3
    bs = np.zeros((n, 4), dtype=np.uint32)
    bs[np.arange(n), nbytes] = 1
    w.set("bs", bs)
    w.set("m1", (1 << (c0 & 7)).astype(np.uint32))
    return c0


def _eval_bits(b, L, is_real):
    cb, ch, bs = L["cb"], L["ch"], L["bs"]
    for x in list(cb) + list(ch) + list(bs):
        b.assert_bool(x)
    c0 = L.word("c")[0]
    packed = sum(cb[i] * (1 << i) for i in range(5)) + sum(
        ch[i] * (1 << (5 + i)) for i in range(3)
    )
    b.when(is_real).assert_eq(c0, packed)
    # one-hot byte shift from bits cb[3], cb[4]
    b.assert_eq(bs[0], (1 - cb[3]) * (1 - cb[4]))
    b.assert_eq(bs[1], cb[3] * (1 - cb[4]))
    b.assert_eq(bs[2], (1 - cb[3]) * cb[4])
    b.assert_eq(bs[3], cb[3] * cb[4])
    # m1 = 2^(bit shift amount)
    m1 = L["m1"]
    b.assert_eq(m1, (1 + cb[0]) * (1 + 3 * cb[1]) * (1 + 15 * cb[2]))
    return m1


class ShiftLeftChip(Air):
    name = "ShiftLeft"
    picus_inputs = ("pc", "next_pc", "next_next_pc", "b", "c", "is_real")
    picus_outputs = ("a", "cb", "ch", "bs", "m1", "lo", "hi")
    cycle_chip = True
    COLS = Layout().add("pc").add("next_pc").add("next_next_pc")
    COLS.word("a").word("b").word("c")
    _bits_layout(COLS)
    COLS.add("lo", 4).add("hi", 4).add("is_real")
    width = COLS.width

    def generate_dependencies(self, record, output):
        rows = _rows(record, (Opcode.SLL,))
        n = len(rows["pc"])
        if n == 0:
            return
        bb = word_decompose_np(rows["b"])
        nb = rows["c"] & 7
        lo = (bb << nb[:, None]) & 0xFF
        hi = np.where(nb[:, None] > 0, bb >> (8 - nb[:, None]), 0)
        count_u8_word(record, lo)
        count_u8_word(record, hi)

    def num_rows(self, record):
        return count_rows(record, (Opcode.SLL,))

    def generate_trace(self, record, output):
        rows = _rows(record, (Opcode.SLL,))
        n = len(rows["pc"])
        w = self.COLS.writer(n)
        for nm in ("pc", "next_pc", "next_next_pc"):
            w.set(nm, rows[nm])
        for nm in ("a", "b", "c"):
            w.set_word(nm, rows[nm])
        c0 = _fill_bits(w, rows["c"], n)
        bb = word_decompose_np(rows["b"])
        nb = (c0 & 7).astype(np.int64)
        lo = (bb << nb[:, None]) & 0xFF
        hi = np.where(nb[:, None] > 0, bb >> (8 - nb[:, None]), 0)
        w.set("lo", lo)
        w.set("hi", hi)
        w.set("is_real", np.ones(n))
        mat = pad_to_pow2(w.mat)
        mat[n:, self.COLS.idx("m1")] = 1
        mat[n:, self.COLS.slc("bs").start] = 1
        return mat

    def eval(self, b):
        L = self.COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        b.receive(
            LookupKind.Instruction,
            instruction_message(
                0, 0, L["pc"], L["next_pc"], L["next_next_pc"], int(Opcode.SLL),
                L.word("a"), L.word("b"), L.word("c"), [0, 0, 0, 0],
                0, 0, 0, 0, 1,
            ),
            is_real,
        )
        m1 = _eval_bits(b, L, is_real)
        a, bw = L.word("a"), L.word("b")
        lo, hi, bs = L["lo"], L["hi"], L["bs"]
        # stage 1: b_i * 2^nb == hi_i * 256 + lo_i, bytes range-checked
        for i in range(4):
            b.assert_zero(bw[i] * m1 - hi[i] * 256 - lo[i])
        send_u8_word(b, lo, is_real)
        send_u8_word(b, hi, is_real)
        # stage 2: a_j = sum_k bs_k * (lo_{j-k} + hi_{j-k-1})
        for j in range(4):
            expr = 0
            for k in range(4):
                if j - k >= 0:
                    term = lo[j - k]
                    if j - k - 1 >= 0:
                        term = term + hi[j - k - 1]
                    expr = bs[k] * term + expr
            b.when(is_real).assert_eq(a[j], expr)


SR_OPS = (Opcode.SRL, Opcode.SRA, Opcode.ROR)
SR_FLAGS = ["is_srl", "is_sra", "is_ror"]


class ShiftRightChip(Air):
    name = "ShiftRight"
    picus_inputs = ("pc", "next_pc", "next_next_pc", "b", "c", "is_srl",
                    "is_sra", "is_ror", "is_real")
    picus_outputs = ("a", "cb", "ch", "bs", "m1", "m2", "w", "shr",
                     "carry", "carry4", "msb_b", "sign_byte")
    cycle_chip = True
    COLS = Layout().add("pc").add("next_pc").add("next_next_pc")
    COLS.word("a").word("b").word("c")
    _bits_layout(COLS)
    for f in SR_FLAGS:
        COLS.add(f)
    COLS.add("m2")  # 2^(8 - nb) i.e. 256 / m1
    COLS.add("w", 4)  # byte-rotated word
    COLS.add("shr", 4).add("carry", 4).add("carry4")
    COLS.add("msb_b").add("sign_byte")
    COLS.add("is_real")
    width = COLS.width

    def generate_dependencies(self, record, output):
        rows = _rows(record, SR_OPS)
        n = len(rows["pc"])
        if n == 0:
            return
        opm = rows["opcode"]
        bb = word_decompose_np(rows["b"])
        c0 = (rows["c"] & 0xFF).astype(np.int64)
        nb = c0 & 7
        wbytes = self._rotated(bb, c0, opm)
        for m in range(4):
            count(record, B.ShrCarry, wbytes[:, m], nb)
        carry = wbytes & ((1 << nb[:, None]) - 1)
        count(record, B.U8Range, carry[:, 0], carry[:, 1])
        count(record, B.U8Range, carry[:, 2], carry[:, 3])
        count(record, B.MSB, bb[:, 3], 0, (opm == int(Opcode.SRA)).astype(np.int64))

    @staticmethod
    def _rotated(bb, c0, opm):
        n = bb.shape[0]
        nbytes = (c0 >> 3) & 3
        out = np.zeros((n, 4), dtype=np.int64)
        msb = (bb[:, 3] >> 7) & 1
        for r in range(n):
            k = nbytes[r]
            for m in range(4):
                src = m + k
                if opm[r] == int(Opcode.ROR):
                    out[r, m] = bb[r, src % 4]
                elif src < 4:
                    out[r, m] = bb[r, src]
                elif opm[r] == int(Opcode.SRA):
                    out[r, m] = 255 * msb[r]
                else:
                    out[r, m] = 0
        return out

    def num_rows(self, record):
        return count_rows(record, SR_OPS)

    def generate_trace(self, record, output):
        rows = _rows(record, SR_OPS)
        n = len(rows["pc"])
        w = self.COLS.writer(n)
        for nm in ("pc", "next_pc", "next_next_pc"):
            w.set(nm, rows[nm])
        for nm in ("a", "b", "c"):
            w.set_word(nm, rows[nm])
        opm = rows["opcode"]
        c0 = _fill_bits(w, rows["c"], n)
        for op, f in zip(SR_OPS, SR_FLAGS):
            w.set(f, (opm == int(op)).astype(np.uint32))
        nb = (c0 & 7).astype(np.int64)
        w.set("m2", (256 >> nb).astype(np.uint32))
        bb = word_decompose_np(rows["b"])
        wb = self._rotated(bb, c0.astype(np.int64), opm)
        w.set("w", wb)
        shr = wb >> nb[:, None]
        carry = wb & ((1 << nb[:, None]) - 1)
        w.set("shr", shr)
        w.set("carry", carry)
        msb = (bb[:, 3] >> 7) & 1
        w.set("msb_b", msb * (opm == int(Opcode.SRA)))
        w.set("sign_byte", 255 * msb * (opm == int(Opcode.SRA)))
        m1 = 1 << nb
        carry4 = np.where(
            opm == int(Opcode.SRA),
            (m1 - 1) * msb,
            np.where(opm == int(Opcode.ROR), carry[:, 0], 0),
        )
        w.set("carry4", carry4)
        w.set("is_real", np.ones(n))
        mat = pad_to_pow2(w.mat)
        mat[n:, self.COLS.idx("m1")] = 1
        mat[n:, self.COLS.slc("bs").start] = 1
        return mat

    def eval(self, b):
        L = self.COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        flags = [L[f] for f in SR_FLAGS]
        acc = 0
        for f in flags:
            b.assert_bool(f)
            acc = f + acc
        b.assert_eq(acc, is_real)
        opcode = sum(f * int(op) for f, op in zip(flags, SR_OPS))
        b.receive(
            LookupKind.Instruction,
            instruction_message(
                0, 0, L["pc"], L["next_pc"], L["next_next_pc"], opcode,
                L.word("a"), L.word("b"), L.word("c"), [0, 0, 0, 0],
                0, 0, 0, 0, 1,
            ),
            is_real,
        )
        m1 = _eval_bits(b, L, is_real)
        m2 = L["m2"]
        b.when(is_real).assert_eq(m1 * m2, 256)
        a, bw = L.word("a"), L.word("b")
        wb, shr, carry = L["w"], L["shr"], L["carry"]
        bs = L["bs"]
        nb = L["cb"][0] + 2 * L["cb"][1] + 4 * L["cb"][2]
        # sign byte
        send_byte(b, B.MSB, bw[3], 0, L["msb_b"], L["is_sra"])
        b.assert_eq(L["sign_byte"], 255 * L["msb_b"])
        b.when(L["is_srl"] + L["is_ror"]).assert_zero(L["msb_b"])
        # byte rotation selection
        for m in range(4):
            srl_expr = 0
            ror_expr = 0
            sra_expr = 0
            for k in range(4):
                src = m + k
                ror_expr = bs[k] * bw[src % 4] + ror_expr
                if src < 4:
                    srl_expr = bs[k] * bw[src] + srl_expr
                    sra_expr = bs[k] * bw[src] + sra_expr
                else:
                    sra_expr = bs[k] * L["sign_byte"] + sra_expr
            b.when(L["is_srl"]).assert_eq(wb[m], srl_expr)
            b.when(L["is_ror"]).assert_eq(wb[m], ror_expr)
            b.when(L["is_sra"]).assert_eq(wb[m], sra_expr)
        # stage: per-byte shift-right-with-carry lookups
        for m in range(4):
            send_byte(
                b, B.ShrCarry, wb[m], nb, shr[m] * 256 + carry[m], is_real
            )
        # carry bytes must be range checked for unique unpacking
        send_byte(b, B.U8Range, carry[0], carry[1], 0, is_real)
        send_byte(b, B.U8Range, carry[2], carry[3], 0, is_real)
        # carry into the top byte
        c4 = L["carry4"]
        b.when(L["is_srl"]).assert_zero(c4)
        b.when(L["is_sra"]).assert_eq(c4, (m1 - 1) * L["msb_b"])
        b.when(L["is_ror"]).assert_eq(c4, carry[0])
        carries = [carry[1], carry[2], carry[3], c4]
        for m in range(4):
            b.assert_zero(shr[m] + carries[m] * m2 - a[m])
