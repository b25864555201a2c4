"""MulChip: MUL / MULT / MULTU — byte-level long multiplication with sign
extension; MULT/MULTU write the HI register through this chip's own memory
access (reference: crates/core/machine/src/alu/mul/mod.rs — the hi access at
clk + HI position with is_check_memory=hi_record_is_real in the dispatch)."""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import Opcode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .layout import Layout, pad_to_pow2, word_decompose_np
from .memory_access import POS_HI, add_access_cols, eval_access, fill_access
from .messages import instruction_message
from .synthetic import count_rows, UNUSED_PC, merged_rows

OPS = (Opcode.MUL, Opcode.MULT, Opcode.MULTU)

COLS = Layout().add("shard").add("clk")
COLS.add("pc").add("next_pc").add("next_next_pc")
COLS.word("a").word("b").word("c").word("hi")
COLS.add("is_mul").add("is_mult").add("is_multu")
COLS.add("is_synth").add("hi_real")
COLS.add("msb_b").add("msb_c")  # sign bits (MULT only)
COLS.add("product", 8).add("carry", 8)
add_access_cols(COLS, "hi_acc", write=True)
COLS.add("is_real")


class MulChip(Air):
    name = "Mul"
    # Picus determinism: operands/flags in, result words + mul witnesses out
    # (hi_acc access columns are multiset-coupled, left unclassified)
    picus_inputs = ("shard", "clk", "pc", "next_pc", "next_next_pc", "b",
                    "c", "is_mul", "is_mult", "is_multu", "is_synth",
                    "hi_real", "is_real")
    picus_outputs = ("a", "hi", "msb_b", "msb_c", "product", "carry")
    cycle_chip = True
    width = COLS.width

    def _rows(self, record):
        cols = record.freeze()
        instrs = record.program.instructions
        ops = np.array([int(instrs[i].opcode) for i in cols["instr_idx"]], dtype=np.int64)
        mask = np.isin(ops, [int(o) for o in OPS])
        rows, n_real = merged_rows(record, OPS)
        return cols, mask, rows, n_real

    @staticmethod
    def _long_mul(bv, cv, opm):
        """Returns (product bytes (n,8), carries (n,8))."""
        n = len(bv)
        bb = word_decompose_np(bv)
        cc = word_decompose_np(cv)
        signed = opm == int(Opcode.MULT)
        sb = ((bb[:, 3] >> 7) & 1) * signed
        sc = ((cc[:, 3] >> 7) & 1) * signed
        be = np.concatenate([bb, np.tile((255 * sb)[:, None], 4)], axis=1).astype(
            np.int64
        )
        ce = np.concatenate([cc, np.tile((255 * sc)[:, None], 4)], axis=1).astype(
            np.int64
        )
        product = np.zeros((n, 8), dtype=np.int64)
        carry = np.zeros((n, 8), dtype=np.int64)
        cur = np.zeros(n, dtype=np.int64)
        for k in range(8):
            s = cur.copy()
            for i in range(k + 1):
                j = k - i
                if i < 8 and j < 8:
                    s += be[:, i] * ce[:, j]
            product[:, k] = s & 0xFF
            cur = s >> 8
            carry[:, k] = cur
        return product, carry, sb, sc

    def generate_dependencies(self, record, output):
        cols, mask, rows, n_real = self._rows(record)
        n = len(rows["pc"])
        if n == 0:
            return
        opm = rows["opcode"]
        product, carry, sb, sc = self._long_mul(rows["b"], rows["c"], opm)
        for k in range(0, 8, 2):
            count(record, B.U8Range, product[:, k], product[:, k + 1])
        for k in range(8):
            count(record, B.U16Range, carry[:, k], 0)
        signed = (opm == int(Opcode.MULT)).astype(np.int64)
        bb = word_decompose_np(rows["b"])
        cc = word_decompose_np(rows["c"])
        count(record, B.MSB, bb[:, 3], 0, signed)
        count(record, B.MSB, cc[:, 3], 0, signed)
        # hi access (real MULT/MULTU rows only)
        opm_r = opm[:n_real]
        writes_hi = np.isin(opm_r, [int(Opcode.MULT), int(Opcode.MULTU)]).astype(
            np.int64
        )
        ts = cols["clk"][mask] + POS_HI
        prev_clk = cols["hi_prev_clk"][mask]
        prev_shard = cols["hi_prev_shard"][mask]
        shard = record.public_values.shard
        compare = (prev_shard == shard).astype(np.int64) * writes_hi
        diff = (
            np.where(compare == 1, ts - prev_clk - 1, shard - prev_shard - 1)
            * writes_hi
        )
        count(record, B.U16Range, diff & 0xFFFF, 0, writes_hi)
        count(record, B.U8Range, diff >> 16, 0, writes_hi)
        hi_val = word_decompose_np(cols["hi_value"][mask])
        count_u8_word(record, hi_val, writes_hi)

    def num_rows(self, record):
        return count_rows(record, OPS)

    def generate_trace(self, record, output):
        cols, mask, rows, n_real = self._rows(record)
        n = len(rows["pc"])
        w = COLS.writer(n)
        opm = rows["opcode"]
        is_synth = np.zeros(n, dtype=np.int64)
        is_synth[n_real:] = 1
        hi_real = (
            np.isin(opm, [int(Opcode.MULT), int(Opcode.MULTU)]).astype(np.int64)
            * (1 - is_synth)
        )
        clk_full = np.zeros(n, dtype=np.int64)
        clk_full[:n_real] = cols["clk"][mask]
        w.set("shard", hi_real * record.public_values.shard)
        w.set("clk", clk_full * hi_real)
        for nm in ("pc", "next_pc", "next_next_pc"):
            w.set(nm, rows[nm])
        for nm in ("a", "b", "c"):
            w.set_word(nm, rows[nm])
        w.set_word("hi", rows["prev_a"])  # hi_or_prev_a carries HI
        w.set("is_mul", (opm == int(Opcode.MUL)).astype(np.uint32))
        w.set("is_mult", (opm == int(Opcode.MULT)).astype(np.uint32))
        w.set("is_multu", (opm == int(Opcode.MULTU)).astype(np.uint32))
        w.set("is_synth", is_synth)
        w.set("hi_real", hi_real)
        product, carry, sb, sc = self._long_mul(rows["b"], rows["c"], opm)
        w.set("msb_b", sb)
        w.set("msb_c", sc)
        w.set("product", product)
        w.set("carry", carry)
        # hi access data exists only for real rows; synthetic rows padded 0
        masked = {}
        for k in ("hi_act", "hi_prev_value", "hi_prev_clk", "hi_prev_shard", "hi_value", "clk"):
            full = np.zeros(n, dtype=np.int64)
            full[:n_real] = cols[k][mask] if k != "clk" else cols["clk"][mask]
            masked[k] = full * hi_real
        fill_access(w, masked, "hi", "hi_acc", POS_HI, write=True,
                    shard=record.public_values.shard)
        w.set("is_real", np.ones(n))
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        is_mul, is_mult, is_multu = L["is_mul"], L["is_mult"], L["is_multu"]
        for f in (is_mul, is_mult, is_multu):
            b.assert_bool(f)
        b.assert_eq(is_mul + is_mult + is_multu, is_real)
        opcode = (
            is_mul * int(Opcode.MUL)
            + is_mult * int(Opcode.MULT)
            + is_multu * int(Opcode.MULTU)
        )
        is_synth, hi_real = L["is_synth"], L["hi_real"]
        b.assert_bool(is_synth)
        b.when(is_synth).assert_eq(L["pc"], UNUSED_PC)
        b.assert_eq(hi_real, (is_mult + is_multu) * (1 - is_synth))
        writes_hi = is_mult + is_multu
        b.receive(
            LookupKind.Instruction,
            instruction_message(
                L["shard"], L["clk"], L["pc"], L["next_pc"], L["next_next_pc"],
                opcode, L.word("a"), L.word("b"), L.word("c"), L.word("hi"),
                0, 0, hi_real, 0, 1,
            ),
            is_real,
        )
        a, bw, cw, hi = L.word("a"), L.word("b"), L.word("c"), L.word("hi")
        # sign bytes
        send_byte(b, B.MSB, bw[3], 0, L["msb_b"], is_mult)
        send_byte(b, B.MSB, cw[3], 0, L["msb_c"], is_mult)
        b.when(is_mul + is_multu).assert_zero(L["msb_b"])
        b.when(is_mul + is_multu).assert_zero(L["msb_c"])
        be = list(bw) + [255 * L["msb_b"]] * 4
        ce = list(cw) + [255 * L["msb_c"]] * 4
        p, carry = L["product"], L["carry"]
        prev = 0
        for k in range(8):
            s = prev
            for i in range(k + 1):
                j = k - i
                if i < 8 and j < 8:
                    s = be[i] * ce[j] + s
            b.assert_zero(s - p[k] - carry[k] * 256)
            prev = carry[k]
        for k in range(0, 8, 2):
            send_byte(b, B.U8Range, p[k], p[k + 1], 0, is_real)
        for k in range(8):
            send_byte(b, B.U16Range, carry[k], 0, 0, is_real)
        # results
        for i in range(4):
            b.when(is_real).assert_eq(a[i], p[i])
            b.when(writes_hi).assert_eq(hi[i], p[4 + i])
            b.when(is_mul).assert_zero(hi[i])
        # HI register write (real MULT/MULTU rows only)
        eval_access(
            b, L, "hi_acc", L["shard"], L["clk"] + POS_HI, 33, hi_real, write=True
        )
        for i in range(4):
            b.when(hi_real).assert_eq(hi[i], L.word("hi_acc_value")[i])
        send_u8_word(b, L.word("hi_acc_value"), hi_real)
        # when hi is not written, shard/clk must be zero (transcript hygiene)
        b.when(1 - hi_real).assert_zero(L["shard"])
        b.when(1 - hi_real).assert_zero(L["clk"])