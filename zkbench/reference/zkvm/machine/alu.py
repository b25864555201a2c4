"""ALU chips. v1: AddSubChip (ADD/SUB with byte carries) and BitwiseChip
(AND/OR/XOR/NOR via byte lookups), LtChip (SLT/SLTU)
(reference: crates/core/machine/src/alu/)."""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import Opcode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, send_byte
from .layout import Layout, pad_to_pow2, word_decompose_np
from .messages import instruction_message
from .synthetic import count_rows, merged_rows


def _passthrough_layout() -> Layout:
    return (
        Layout()
        .add("pc")
        .add("next_pc")
        .add("next_next_pc")
        .word("a")
        .word("b")
        .word("c")
        .add("is_real")
    )


def _fill_passthrough(w, rows):
    w.set("pc", rows["pc"])
    w.set("next_pc", rows["next_pc"])
    w.set("next_next_pc", rows["next_next_pc"])
    w.set_word("a", rows["a"])
    w.set_word("b", rows["b"])
    w.set_word("c", rows["c"])
    w.set("is_real", np.ones(len(rows["pc"])))


def _recv_alu(b, L, opcode_expr):
    """Receive the uniform instruction message for a plain ALU op."""
    zero4 = [0, 0, 0, 0]
    b.receive(
        LookupKind.Instruction,
        instruction_message(
            0, 0, L["pc"], L["next_pc"], L["next_next_pc"], opcode_expr,
            L.word("a"), L.word("b"), L.word("c"), zero4,
            0, 0, 0, 0, 1,
        ),
        L["is_real"],
    )


class AddSubChip(Air):
    name = "AddSub"
    cycle_chip = True
    OPS = (Opcode.ADD, Opcode.SUB)
    COLS = _passthrough_layout().add("is_add").add("is_sub").add("carry", 4)
    width = COLS.width
    picus_inputs = ('pc', 'next_pc', 'next_next_pc', 'b', 'c', 'is_add', 'is_sub', 'is_real')
    picus_outputs = ('a', 'carry')

    def num_rows(self, record):
        return count_rows(record, self.OPS)

    def generate_trace(self, record, output):
        rows, _ = merged_rows(record, (Opcode.ADD, Opcode.SUB))
        n = len(rows["pc"])
        w = self.COLS.writer(n)
        _fill_passthrough(w, rows)
        is_add = (rows["opcode"] == int(Opcode.ADD)).astype(np.uint32)
        w.set("is_add", is_add)
        w.set("is_sub", 1 - is_add)
        # carries of (in1 + c) = out where in1 = add? b : a, out = add? a : b
        a, bb, c = rows["a"], rows["b"], rows["c"]
        in1 = np.where(is_add == 1, bb, a)
        out = np.where(is_add == 1, a, bb)
        in1b, cb, outb = (word_decompose_np(x) for x in (in1, c, out))
        carries = np.zeros((n, 4), dtype=np.uint32)
        cur = np.zeros(n, dtype=np.int64)
        for i in range(4):
            s = in1b[:, i].astype(np.int64) + cb[:, i] + cur
            cur = s >> 8
            carries[:, i] = cur
        w.set("carry", carries)
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = self.COLS.view(b.main_local)
        is_add, is_sub = L["is_add"], L["is_sub"]
        is_real = L["is_real"]
        b.assert_bool(is_add)
        b.assert_bool(is_sub)
        b.assert_eq(is_add + is_sub, is_real)
        b.assert_bool(is_real)
        opcode = is_add * int(Opcode.ADD) + is_sub * int(Opcode.SUB)
        _recv_alu(b, L, opcode)
        a, bw, c, carry = L.word("a"), L.word("b"), L.word("c"), L["carry"]
        prev_carry = 0
        for i in range(4):
            in1 = is_add * bw[i] + is_sub * a[i]
            out = is_add * a[i] + is_sub * bw[i]
            b.assert_bool(carry[i])
            b.assert_zero(in1 + c[i] + prev_carry - carry[i] * 256 - out)
            prev_carry = carry[i]


class BitwiseChip(Air):
    name = "Bitwise"
    cycle_chip = True
    picus_inputs = ("pc", "next_pc", "next_next_pc", "b", "c", "is_and",
                    "is_or", "is_xor", "is_nor", "is_real")
    picus_outputs = ("a",)
    OPS = (Opcode.AND, Opcode.OR, Opcode.XOR, Opcode.NOR)
    COLS = (
        _passthrough_layout().add("is_and").add("is_or").add("is_xor").add("is_nor")
    )
    width = COLS.width
    _BYTE_OP = {
        Opcode.AND: B.AND, Opcode.OR: B.OR, Opcode.XOR: B.XOR, Opcode.NOR: B.NOR
    }

    def generate_dependencies(self, record, output):
        rows, _ = merged_rows(record, self.OPS)
        bb = word_decompose_np(rows["b"])
        c = word_decompose_np(rows["c"])
        opm = rows["opcode"]
        for op in self.OPS:
            sub = opm == int(op)
            for i in range(4):
                count(record, self._BYTE_OP[op], bb[sub, i], c[sub, i])

    def num_rows(self, record):
        return count_rows(record, self.OPS)

    def generate_trace(self, record, output):
        rows, _ = merged_rows(record, self.OPS)
        n = len(rows["pc"])
        w = self.COLS.writer(n)
        _fill_passthrough(w, rows)
        opm = rows["opcode"]
        for op, nm in zip(self.OPS, ("is_and", "is_or", "is_xor", "is_nor")):
            w.set(nm, (opm == int(op)).astype(np.uint32))
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = self.COLS.view(b.main_local)
        flags = [L["is_and"], L["is_or"], L["is_xor"], L["is_nor"]]
        is_real = L["is_real"]
        acc = 0
        for f in flags:
            b.assert_bool(f)
            acc = f + acc
        b.assert_eq(acc, is_real)
        b.assert_bool(is_real)
        opcode = sum(f * int(op) for f, op in zip(flags, self.OPS))
        _recv_alu(b, L, opcode)
        a, bw, c = L.word("a"), L.word("b"), L.word("c")
        for i in range(4):
            for f, op in zip(flags, self.OPS):
                send_byte(b, self._BYTE_OP[op], bw[i], c[i], a[i], f)


class LtChip(Air):
    """SLT/SLTU via byte comparison: find the most significant differing
    byte with one-hot flags, compare it with an LTU lookup; signed compare
    flips the result when the sign bits differ."""

    name = "Lt"
    cycle_chip = True
    OPS = (Opcode.SLT, Opcode.SLTU)
    picus_inputs = ("pc", "next_pc", "next_next_pc", "b", "c", "is_slt",
                    "is_sltu", "is_real")
    picus_outputs = ("a", "diff_flag", "all_eq", "cmp_b", "cmp_c",
                     "ltu_result", "msb_b", "msb_c", "signs_differ",
                     "diff_inv")
    COLS = (
        _passthrough_layout()
        .add("is_slt")
        .add("is_sltu")
        .add("diff_flag", 4)  # one-hot: most significant differing byte
        .add("all_eq")  # b == c
        .add("cmp_b")  # compared byte of b (after sign adjustment)
        .add("cmp_c")
        .add("ltu_result")
        .add("msb_b")
        .add("msb_c")
        .add("signs_differ")
        .add("diff_inv")
    )
    width = COLS.width

    def generate_dependencies(self, record, output):
        rows, _ = merged_rows(record, self.OPS)
        bb = word_decompose_np(rows["b"])
        cc = word_decompose_np(rows["c"])
        opm = rows["opcode"]
        is_slt = (opm == int(Opcode.SLT)).astype(np.int64)
        cmp_b, cmp_c, _, _, _ = self._cmp_bytes(bb, cc)
        count(record, B.LTU, cmp_b, cmp_c)
        count(record, B.MSB, bb[:, 3], 0, is_slt)
        count(record, B.MSB, cc[:, 3], 0, is_slt)

    @staticmethod
    def _cmp_bytes(bb, cc):
        n = bb.shape[0]
        diff_flag = np.zeros((n, 4), dtype=np.uint32)
        cmp_b = np.zeros(n, dtype=np.int64)
        cmp_c = np.zeros(n, dtype=np.int64)
        all_eq = np.ones(n, dtype=np.uint32)
        for r in range(n):
            for i in (3, 2, 1, 0):
                if bb[r, i] != cc[r, i]:
                    diff_flag[r, i] = 1
                    cmp_b[r] = bb[r, i]
                    cmp_c[r] = cc[r, i]
                    all_eq[r] = 0
                    break
        return cmp_b, cmp_c, diff_flag, all_eq, None

    def num_rows(self, record):
        return count_rows(record, self.OPS)

    def generate_trace(self, record, output):
        rows, _ = merged_rows(record, self.OPS)
        n = len(rows["pc"])
        w = self.COLS.writer(n)
        _fill_passthrough(w, rows)
        opm = rows["opcode"]
        is_slt = (opm == int(Opcode.SLT)).astype(np.uint32)
        w.set("is_slt", is_slt)
        w.set("is_sltu", 1 - is_slt)
        bb = word_decompose_np(rows["b"])
        cc = word_decompose_np(rows["c"])
        cmp_b, cmp_c, diff_flag, all_eq, _ = self._cmp_bytes(bb, cc)
        w.set("diff_flag", diff_flag)
        w.set("all_eq", all_eq)
        w.set("cmp_b", cmp_b)
        w.set("cmp_c", cmp_c)
        w.set("ltu_result", (cmp_b < cmp_c).astype(np.uint32))
        msb_b = (bb[:, 3] >> 7) & 1
        msb_c = (cc[:, 3] >> 7) & 1
        w.set("msb_b", msb_b)
        w.set("msb_c", msb_c)
        w.set("signs_differ", (msb_b ^ msb_c).astype(np.uint32) * is_slt)
        P = 2130706433
        d = (cmp_b - cmp_c) % P
        w.set("diff_inv", np.array([pow(int(x), P - 2, P) if x else 0 for x in d]))
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = self.COLS.view(b.main_local)
        is_slt, is_sltu, is_real = L["is_slt"], L["is_sltu"], L["is_real"]
        b.assert_bool(is_slt)
        b.assert_bool(is_sltu)
        b.assert_eq(is_slt + is_sltu, is_real)
        b.assert_bool(is_real)
        opcode = is_slt * int(Opcode.SLT) + is_sltu * int(Opcode.SLTU)
        _recv_alu(b, L, opcode)
        a, bw, c = L.word("a"), L.word("b"), L.word("c")
        flags = L["diff_flag"]
        all_eq = L["all_eq"]
        # flag structure: one-hot or zero; all_eq complements
        acc = all_eq
        for i in range(4):
            b.assert_bool(flags[i])
            acc = acc + flags[i]
        b.assert_bool(all_eq)
        b.when(is_real).assert_one(acc)
        # flagged byte selected into cmp_b/cmp_c
        for i in range(4):
            b.when(flags[i]).assert_eq(L["cmp_b"], bw[i])
            b.when(flags[i]).assert_eq(L["cmp_c"], c[i])
        # bytes above the differing byte must be equal (byte i is equal when
        # all bytes are equal or the most significant differing byte is below)
        for i in range(4):
            eq_needed = all_eq
            for j in range(i):
                eq_needed = eq_needed + flags[j]
            b.when(eq_needed).assert_eq(bw[i], c[i])
        b.when(all_eq).assert_eq(L["cmp_b"], L["cmp_c"])
        # the flagged byte must actually differ (inverse witness)
        sum_flags = flags[0] + flags[1] + flags[2] + flags[3]
        b.when(sum_flags).assert_zero(
            (L["cmp_b"] - L["cmp_c"]) * L["diff_inv"] - 1
        )
        send_byte(b, B.LTU, L["cmp_b"], L["cmp_c"], L["ltu_result"], is_real)
        send_byte(b, B.MSB, bw[3], 0, L["msb_b"], is_slt)
        send_byte(b, B.MSB, c[3], 0, L["msb_c"], is_slt)
        # unsigned result
        unsigned = L["ltu_result"]
        # signed: if signs differ, result = msb_b (b negative -> b < c)
        sd = L["signs_differ"]
        b.when(is_slt).assert_eq(
            sd, L["msb_b"] + L["msb_c"] - 2 * L["msb_b"] * L["msb_c"]
        )
        b.when(is_sltu).assert_zero(sd)
        result_slt = sd * L["msb_b"] + (1 - sd) * unsigned
        b.when(is_sltu).assert_eq(a[0], unsigned)
        b.when(is_slt).assert_eq(a[0], result_slt)
        for i in range(1, 4):
            b.assert_zero(a[i])
