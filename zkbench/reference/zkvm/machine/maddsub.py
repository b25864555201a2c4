"""MaddSubChip: MADD / MADDU / MSUB / MSUBU — multiply-accumulate into
(HI, LO) (reference: crates/core/machine/src/misc/others maddsub columns).

acc' = acc ± b*c over 64 bits, where acc = (HI << 32) | LO. The product
comes from a synthetic MULT/MULTU; the accumulate is an 8-byte carry chain.
LO is the op_a register (prev_a = old LO via is_rw_a); HI is accessed here.
"""

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
from .synthetic import count_rows, emit, merged_rows

M32 = 0xFFFFFFFF
OPS = (Opcode.MADD, Opcode.MADDU, Opcode.MSUB, Opcode.MSUBU)

COLS = Layout().add("shard").add("clk")
COLS.add("pc").add("next_pc").add("next_next_pc")
COLS.word("a").word("b").word("c").word("prev_a")  # prev_a = old LO
COLS.add("is_madd").add("is_maddu").add("is_msub").add("is_msubu")
COLS.word("mlo").word("mhi")  # b*c as 64-bit halves
COLS.add("acc_carry", 8)
add_access_cols(COLS, "hi_acc", write=True)  # prev = old HI, value = new HI
COLS.add("is_real")


def _s32(x):
    x = np.asarray(x, dtype=np.int64)
    return np.where(x >= 1 << 31, x - (1 << 32), x)


class MaddSubChip(Air):
    name = "MaddSub"
    picus_inputs = ("shard", "clk", "pc", "next_pc", "next_next_pc", "b",
                    "c", "prev_a", "is_madd", "is_maddu", "is_msub",
                    "is_msubu", "is_real")
    picus_outputs = ("a", "mlo", "mhi", "acc_carry")
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
    def _product(rows):
        opm = rows["opcode"]
        signed = np.isin(opm, [int(Opcode.MADD), int(Opcode.MSUB)])
        out = []
        for i in range(len(opm)):
            bb, cc = int(rows["b"][i]), int(rows["c"][i])
            if signed[i]:
                p = int(_s32([bb])[0]) * int(_s32([cc])[0])  # python ints: no int64 overflow
            else:
                p = bb * cc
            out.append(p & ((1 << 64) - 1))
        return out, signed

    def emit_synthetic(self, record):
        rows, _ = merged_rows(record, OPS)
        if len(rows["pc"]) == 0:
            return
        prods, signed = self._product(rows)
        for i, p in enumerate(prods):
            op = Opcode.MULT if signed[i] else Opcode.MULTU
            emit(record, op, p & M32, rows["b"][i], rows["c"][i], p >> 32)

    def generate_dependencies(self, record, output):
        cols, mask, rows, n_real = self._rows(record)
        n = len(rows["pc"])
        if n == 0:
            return
        # hi access diffs + new HI range check
        ts = cols["clk"][mask] + POS_HI
        prev_clk = cols["hi_prev_clk"][mask]
        prev_shard = cols["hi_prev_shard"][mask]
        ones = np.ones(n_real, dtype=np.int64)
        shard = record.public_values.shard
        compare = (prev_shard == shard).astype(np.int64)
        diff = np.where(compare == 1, ts - prev_clk - 1, shard - prev_shard - 1)
        count(record, B.U16Range, diff & 0xFFFF, 0, ones)
        count(record, B.U8Range, diff >> 16, 0, ones)
        count_u8_word(record, word_decompose_np(cols["hi_value"][mask]))

    def num_rows(self, record):
        return count_rows(record, OPS)

    def generate_trace(self, record, output):
        cols, mask, rows, n_real = self._rows(record)
        n = len(rows["pc"])
        assert n == n_real, "maddsub has no synthetic rows"
        w = COLS.writer(n)
        w.set("shard", np.full(n, record.public_values.shard))
        w.set("clk", cols["clk"][mask])
        for nm in ("pc", "next_pc", "next_next_pc"):
            w.set(nm, rows[nm])
        for nm in ("a", "b", "c", "prev_a"):
            w.set_word(nm, rows[nm])
        opm = rows["opcode"]
        for op, f in zip(OPS, ("is_madd", "is_maddu", "is_msub", "is_msubu")):
            w.set(f, (opm == int(op)).astype(np.uint32))
        prods, signed = self._product(rows)
        mlo = np.array([p & M32 for p in prods], dtype=np.int64)
        mhi = np.array([p >> 32 for p in prods], dtype=np.int64)
        w.set_word("mlo", mlo)
        w.set_word("mhi", mhi)
        # acc_new = acc_old ± m  ->  check addend identity byte-wise:
        #   MADD*: old + m == new;  MSUB*: new + m == old
        is_sub = np.isin(opm, [int(Opcode.MSUB), int(Opcode.MSUBU)])
        old_lo = rows["prev_a"]
        old_hi = cols["hi_prev_value"][mask]
        new_lo = rows["a"]
        new_hi = cols["hi_value"][mask]
        lhs_lo = np.where(is_sub, new_lo, old_lo)
        lhs_hi = np.where(is_sub, new_hi, old_hi)
        out_lo = np.where(is_sub, old_lo, new_lo)
        out_hi = np.where(is_sub, old_hi, new_hi)
        lb = np.concatenate(
            [word_decompose_np(lhs_lo), word_decompose_np(lhs_hi)], axis=1
        ).astype(np.int64)
        mb = np.concatenate(
            [word_decompose_np(mlo), word_decompose_np(mhi)], axis=1
        ).astype(np.int64)
        ob = np.concatenate(
            [word_decompose_np(out_lo), word_decompose_np(out_hi)], axis=1
        ).astype(np.int64)
        carries = np.zeros((n, 8), dtype=np.int64)
        cur = np.zeros(n, dtype=np.int64)
        for k in range(8):
            s = lb[:, k] + mb[:, k] + cur
            assert np.all((s & 0xFF) == ob[:, k]), "maddsub accumulate mismatch"
            cur = s >> 8
            carries[:, k] = cur
        w.set("acc_carry", carries)
        masked = {k: cols[k][mask] for k in
                  ("hi_act", "hi_prev_value", "hi_prev_clk", "hi_prev_shard", "hi_value", "clk")}
        fill_access(w, masked, "hi", "hi_acc", POS_HI, write=True,
                    shard=record.public_values.shard)
        w.set("is_real", np.ones(n))
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        flags = [L["is_madd"], L["is_maddu"], L["is_msub"], L["is_msubu"]]
        acc = 0
        for f in flags:
            b.assert_bool(f)
            acc = f + acc
        b.assert_eq(acc, is_real)
        opcode = sum(f * int(op) for f, op in zip(flags, OPS))
        is_signed = L["is_madd"] + L["is_msub"]
        is_unsigned = L["is_maddu"] + L["is_msubu"]
        is_sub = L["is_msub"] + L["is_msubu"]
        b.receive(
            LookupKind.Instruction,
            instruction_message(
                L["shard"], L["clk"], L["pc"], L["next_pc"], L["next_next_pc"],
                opcode, L.word("a"), L.word("b"), L.word("c"), L.word("prev_a"),
                0, is_real, is_real, 0, 1,
            ),
            is_real,
        )
        # synthetic multiply
        mlo, mhi = L.word("mlo"), L.word("mhi")
        b.send(
            LookupKind.Instruction,
            instruction_message(
                0, 0, 1, 5, 9,
                is_signed * int(Opcode.MULT) + is_unsigned * int(Opcode.MULTU),
                mlo, L.word("b"), L.word("c"), mhi, 0, 0, 0, 0, 1,
            ),
            is_real,
        )
        # HI access: prev = old HI, value = new HI
        eval_access(
            b, L, "hi_acc", L["shard"], L["clk"] + POS_HI, 33, is_real, write=True
        )
        old_hi = L.word("hi_acc_prev_value")
        new_hi = L.word("hi_acc_value")
        send_u8_word(b, new_hi, is_real)
        old_lo = L.word("prev_a")
        new_lo = L.word("a")
        # accumulate: (lhs) + m == (out) over 8 bytes
        carry = L["acc_carry"]
        prev = 0
        for k in range(8):
            lo_k = k < 4
            i = k if lo_k else k - 4
            lhs = (
                is_sub * (new_lo[i] if lo_k else new_hi[i])
                + (1 - is_sub) * (old_lo[i] if lo_k else old_hi[i])
            )
            out = (
                is_sub * (old_lo[i] if lo_k else old_hi[i])
                + (1 - is_sub) * (new_lo[i] if lo_k else new_hi[i])
            )
            m = mlo[i] if lo_k else mhi[i]
            b.assert_bool(carry[k])
            b.assert_zero(lhs + m + prev - carry[k] * 256 - out)
            prev = carry[k]
