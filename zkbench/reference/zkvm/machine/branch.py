"""BranchChip: BEQ/BNE/BGEZ/BGTZ/BLEZ/BLTZ with delay-slot target
computation (reference: crates/core/machine/src/control_flow/branch)."""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import Opcode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .layout import Layout, pack_word, pad_to_pow2, word_decompose_np
from .messages import instruction_message
from .synthetic import count_rows

P = 2130706433
OPS = (Opcode.BEQ, Opcode.BNE, Opcode.BGEZ, Opcode.BGTZ, Opcode.BLEZ, Opcode.BLTZ)
FLAG_NAMES = ["is_beq", "is_bne", "is_bgez", "is_bgtz", "is_blez", "is_bltz"]

COLS = Layout().add("pc").add("next_pc").add("next_next_pc")
COLS.word("a").word("b").word("c")
for f in FLAG_NAMES:
    COLS.add(f)
COLS.add("eq_byte", 4)  # per-byte equality flags of (a, b)
COLS.add("eq_inv", 4)  # inverse witnesses for differing bytes
COLS.add("eq01")  # eq_byte[0] * eq_byte[1]
COLS.add("eq")  # a == b
COLS.add("msb_a")  # sign bit of a
COLS.add("taken")
COLS.word("next_pc_word")  # byte decomposition of next_pc
COLS.word("target")  # next_pc + c (mod 2^32)
COLS.add("t_carry", 4)
COLS.add("is_real")


class BranchChip(Air):
    name = "Branch"
    # eq_inv is a free inverse witness: unclassified
    picus_inputs = ("pc", "next_pc", "next_next_pc", "a", "b", "c",
                    "is_beq", "is_bne", "is_bgez", "is_bgtz", "is_blez",
                    "is_bltz", "is_real")
    picus_outputs = ("eq_byte", "eq01", "eq", "msb_a", "taken",
                     "next_pc_word", "target", "t_carry")
    cycle_chip = True
    width = COLS.width

    def _rows(self, record):
        cols = record.freeze()
        instrs = record.program.instructions
        ops = np.array([int(instrs[i].opcode) for i in cols["instr_idx"]], dtype=np.int64)
        mask = np.isin(ops, [int(o) for o in OPS])
        return cols, mask, ops

    def generate_dependencies(self, record, output):
        cols, mask, ops = self._rows(record)
        n = int(mask.sum())
        if n == 0:
            return
        a = word_decompose_np(cols["a"][mask])
        npc = word_decompose_np(cols["next_pc"][mask])
        target_u32 = (cols["next_pc"][mask] + cols["c"][mask]) % (1 << 32)
        tb = word_decompose_np(target_u32)
        taken = (cols["next_next_pc"][mask] != (cols["next_pc"][mask] + 4)).astype(
            np.int64
        )
        # recompute actual taken (next_next may equal next_pc+4 even if taken)
        taken = self._taken(ops[mask], cols["a"][mask], cols["b"][mask])
        ones = np.ones(n, dtype=np.int64)
        count(record, B.MSB, a[:, 3], 0, ones)
        count_u8_word(record, npc, ones)
        count_u8_word(record, tb, ones)
        count(record, B.MSB, tb[:, 3], 0, taken)

    @staticmethod
    def _taken(ops, a, bb):
        s32 = lambda x: np.where(x >= 1 << 31, x.astype(np.int64) - (1 << 32), x)
        sa = s32(a)
        out = np.zeros(len(ops), dtype=np.int64)
        out[ops == int(Opcode.BEQ)] = (a == bb)[ops == int(Opcode.BEQ)]
        out[ops == int(Opcode.BNE)] = (a != bb)[ops == int(Opcode.BNE)]
        out[ops == int(Opcode.BGEZ)] = (sa >= 0)[ops == int(Opcode.BGEZ)]
        out[ops == int(Opcode.BGTZ)] = (sa > 0)[ops == int(Opcode.BGTZ)]
        out[ops == int(Opcode.BLEZ)] = (sa <= 0)[ops == int(Opcode.BLEZ)]
        out[ops == int(Opcode.BLTZ)] = (sa < 0)[ops == int(Opcode.BLTZ)]
        return out

    def num_rows(self, record):
        return count_rows(record, OPS)

    def generate_trace(self, record, output):
        cols, mask, ops = self._rows(record)
        n = int(mask.sum())
        w = COLS.writer(n)
        for nm in ("pc", "next_pc", "next_next_pc"):
            w.set(nm, cols[nm][mask])
        for nm in ("a", "b", "c"):
            w.set_word(nm, cols[nm][mask])
        opm = ops[mask]
        for op, f in zip(OPS, FLAG_NAMES):
            w.set(f, (opm == int(op)).astype(np.uint32))
        a = word_decompose_np(cols["a"][mask])
        bb = word_decompose_np(cols["b"][mask])
        eq_b = (a == bb).astype(np.uint32)
        w.set("eq_byte", eq_b)
        d = (a.astype(np.int64) - bb) % P
        from ..core.field import finv

        w.set("eq_inv", finv(d.astype(np.uint32)))  # finv(0) == 0
        w.set("eq01", eq_b[:, 0] * eq_b[:, 1])
        w.set("eq", eq_b.all(axis=1).astype(np.uint32))
        w.set("msb_a", (a[:, 3] >> 7) & 1)
        w.set("taken", self._taken(opm, cols["a"][mask], cols["b"][mask]))
        w.set_word("next_pc_word", cols["next_pc"][mask])
        target_u32 = (cols["next_pc"][mask] + cols["c"][mask]) % (1 << 32)
        w.set_word("target", target_u32)
        npcb = word_decompose_np(cols["next_pc"][mask])
        cb = word_decompose_np(cols["c"][mask])
        carries = np.zeros((n, 4), dtype=np.uint32)
        cur = np.zeros(n, dtype=np.int64)
        for i in range(4):
            s = npcb[:, i].astype(np.int64) + cb[:, i] + cur
            cur = s >> 8
            carries[:, i] = cur
        w.set("t_carry", carries)
        w.set("is_real", np.ones(n))
        mat = pad_to_pow2(w.mat)
        # padding rows: a == b == 0, so the equality gadget needs e_i = 1
        mat[n:, COLS.slc("eq_byte")] = 1
        mat[n:, COLS.idx("eq01")] = 1
        mat[n:, COLS.idx("eq")] = 1
        return mat

    def eval(self, b):
        L = COLS.view(b.main_local)
        is_real = L["is_real"]
        flags = [L[f] for f in FLAG_NAMES]
        b.assert_bool(is_real)
        acc = 0
        for f in flags:
            b.assert_bool(f)
            acc = f + acc
        b.assert_eq(acc, is_real)
        opcode = sum(f * int(op) for f, op in zip(flags, OPS))

        b.receive(
            LookupKind.Instruction,
            instruction_message(
                0, 0, L["pc"], L["next_pc"], L["next_next_pc"], opcode,
                L.word("a"), L.word("b"), L.word("c"), [0, 0, 0, 0],
                is_real, 0, 0, 0, 0,  # op_a_immutable=1, sequential=0
            ),
            is_real,
        )

        a, bw, c = L.word("a"), L.word("b"), L.word("c")
        # word equality gadget
        e = L["eq_byte"]
        inv = L["eq_inv"]
        for i in range(4):
            b.assert_bool(e[i])
            b.assert_zero(e[i] * (a[i] - bw[i]))
            b.assert_zero((1 - e[i]) * ((a[i] - bw[i]) * inv[i] - 1))
        b.assert_eq(L["eq01"], e[0] * e[1])
        b.assert_eq(L["eq"], L["eq01"] * (e[2] * e[3]))
        eq = L["eq"]
        # sign bit
        send_byte(b, B.MSB, a[3], 0, L["msb_a"], is_real)
        msb = L["msb_a"]
        taken = L["taken"]
        b.assert_bool(taken)
        b.when(L["is_beq"]).assert_eq(taken, eq)
        b.when(L["is_bne"]).assert_eq(taken, 1 - eq)
        b.when(L["is_bgez"]).assert_eq(taken, 1 - msb)
        b.when(L["is_bltz"]).assert_eq(taken, msb)
        b.when(L["is_bgtz"]).assert_eq(taken, (1 - msb) * (1 - eq))
        b.when(L["is_blez"]).assert_eq(taken, msb + (1 - msb) * eq)

        # next_pc decomposition and branch target add
        npw = L.word("next_pc_word")
        b.when(is_real).assert_eq(pack_word(npw), L["next_pc"])
        send_u8_word(b, npw, is_real)
        t, tc = L.word("target"), L["t_carry"]
        prev = 0
        for i in range(4):
            b.assert_bool(tc[i])
            b.when(is_real).assert_zero(npw[i] + c[i] + prev - tc[i] * 256 - t[i])
            prev = tc[i]
        send_u8_word(b, t, is_real)
        send_byte(b, B.MSB, t[3], 0, 0, taken)  # target < 2^31 when taken
        b.when(taken).assert_eq(L["next_next_pc"], pack_word(t))
        b.when(is_real).when(1 - taken).assert_eq(
            L["next_next_pc"], L["next_pc"] + 4
        )
