"""JumpChip: Jump (JR/JALR), Jumpi (J/JAL), JumpDirect (BAL)
(reference: crates/core/machine/src/control_flow/jump)."""

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

OPS = (Opcode.Jump, Opcode.Jumpi, Opcode.JumpDirect)
FLAGS = ["is_jump", "is_jumpi", "is_jumpdirect"]

COLS = Layout().add("pc").add("next_pc").add("next_next_pc")
COLS.word("a").word("b")
for f in FLAGS:
    COLS.add(f)
COLS.word("next_pc_word")
COLS.word("target")  # JumpDirect: next_pc + b (mod 2^32)
COLS.add("t_carry", 4)
COLS.add("is_real")


class JumpChip(Air):
    name = "Jump"
    picus_inputs = ("pc", "next_pc", "next_next_pc", "b", "is_jump",
                    "is_jumpi", "is_jumpdirect", "is_real")
    picus_outputs = ("a", "next_pc_word", "target", "t_carry")
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
        bb = word_decompose_np(cols["b"][mask])
        npc = word_decompose_np(cols["next_pc"][mask])
        target = word_decompose_np(
            (cols["next_pc"][mask] + cols["b"][mask]) % (1 << 32)
        )
        ones = np.ones(n, dtype=np.int64)
        opm = ops[mask]
        is_jd = (opm == int(Opcode.JumpDirect)).astype(np.int64)
        count(record, B.MSB, a[:, 3], 0, ones)
        count(record, B.MSB, bb[:, 3], 0, 1 - is_jd)
        count_u8_word(record, npc, is_jd)
        count_u8_word(record, target, is_jd)
        count(record, B.MSB, target[:, 3], 0, is_jd)

    def num_rows(self, record):
        return count_rows(record, OPS)

    def generate_trace(self, record, output):
        cols, mask, ops = self._rows(record)
        n = int(mask.sum())
        w = COLS.writer(n)
        for nm in ("pc", "next_pc", "next_next_pc"):
            w.set(nm, cols[nm][mask])
        w.set_word("a", cols["a"][mask])
        w.set_word("b", cols["b"][mask])
        opm = ops[mask]
        for op, f in zip(OPS, FLAGS):
            w.set(f, (opm == int(op)).astype(np.uint32))
        w.set_word("next_pc_word", cols["next_pc"][mask])
        target = (cols["next_pc"][mask] + cols["b"][mask]) % (1 << 32)
        w.set_word("target", target)
        npcb = word_decompose_np(cols["next_pc"][mask])
        bbb = word_decompose_np(cols["b"][mask])
        carries = np.zeros((n, 4), dtype=np.uint32)
        cur = np.zeros(n, dtype=np.int64)
        for i in range(4):
            s = npcb[:, i].astype(np.int64) + bbb[:, i] + cur
            cur = s >> 8
            carries[:, i] = cur
        w.set("t_carry", carries)
        w.set("is_real", np.ones(n))
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = COLS.view(b.main_local)
        is_real = L["is_real"]
        flags = [L[f] for f in FLAGS]
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
                L.word("a"), L.word("b"), [0, 0, 0, 0], [0, 0, 0, 0],
                0, 0, 0, 0, 0,
            ),
            is_real,
        )
        a, bw = L.word("a"), L.word("b")
        # link register value: a == next_pc + 4, a < 2^31
        b.when(is_real).assert_eq(pack_word(a), L["next_pc"] + 4)
        send_byte(b, B.MSB, a[3], 0, 0, is_real)
        # Jump / Jumpi: target = b (packed), must be < 2^31
        not_jd = L["is_jump"] + L["is_jumpi"]
        b.when(not_jd).assert_eq(L["next_next_pc"], pack_word(bw))
        send_byte(b, B.MSB, bw[3], 0, 0, not_jd)
        # JumpDirect: target = next_pc + b (mod 2^32)
        jd = L["is_jumpdirect"]
        npw = L.word("next_pc_word")
        b.when(jd).assert_eq(pack_word(npw), L["next_pc"])
        send_u8_word(b, npw, jd)
        t, tc = L.word("target"), L["t_carry"]
        prev = 0
        for i in range(4):
            b.assert_bool(tc[i])
            b.when(jd).assert_zero(npw[i] + bw[i] + prev - tc[i] * 256 - t[i])
            prev = tc[i]
        send_u8_word(b, t, jd)
        send_byte(b, B.MSB, t[3], 0, 0, jd)
        b.when(jd).assert_eq(L["next_next_pc"], pack_word(t))
