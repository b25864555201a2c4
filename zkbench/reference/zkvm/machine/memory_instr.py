"""MemoryInstructionsChip: LB/LBU/LH/LHU/LW/LWL/LWR/LL/SB/SH/SW/SWL/SWR/SC
(reference: crates/core/machine/src/memory/instructions/).

Address = b + c (mod 2^32) via byte carries; the aligned word is accessed in
the Memory multiset at timestamp clk (Memory position); sub-word semantics
are byte muxes driven by the one-hot low-address flags; LB/LH sign-extend
via an MSB byte lookup.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import LOAD_OPCODES, Opcode, STORE_OPCODES
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .layout import Layout, pack_word, pad_to_pow2, word_decompose_np
from .memory_access import add_access_cols, eval_access, fill_access
from .messages import instruction_message
from .synthetic import count_rows

P = 2130706433
OPS = (
    Opcode.LB, Opcode.LBU, Opcode.LH, Opcode.LHU, Opcode.LW, Opcode.LWL,
    Opcode.LWR, Opcode.LL, Opcode.SB, Opcode.SH, Opcode.SW, Opcode.SWL,
    Opcode.SWR, Opcode.SC,
)
FLAGS = {op: f"is_{op.name.lower()}" for op in OPS}

COLS = Layout().add("shard").add("clk")
COLS.add("pc").add("next_pc").add("next_next_pc")
COLS.word("a").word("b").word("c").word("prev_a")
for f in FLAGS.values():
    COLS.add(f)
COLS.word("addr_word").add("a_carry", 4)
COLS.add("l0").add("l1").add("ls", 4).add("al0")
COLS.add("hi_sum_inv")  # inverse of addr_word[1]+addr_word[2]+addr_word[3]
COLS.add("sel0").add("sel1").add("msb_sel")
add_access_cols(COLS, "mem", write=True)
COLS.add("is_real")

_WORD_OPS = (Opcode.LW, Opcode.LL, Opcode.SW, Opcode.SC)
_HALF_OPS = (Opcode.LH, Opcode.LHU, Opcode.SH)


class MemoryInstructionsChip(Air):
    picus_inputs = ("shard", "clk", "pc", "next_pc", "next_next_pc",
                    "b", "c", "prev_a", "is_real")
    picus_outputs = ("a", "addr_word", "a_carry", "l0", "l1", "ls", "al0",
                     "hi_sum_inv", "sel0", "sel1", "msb_sel")
    name = "MemoryInstructions"
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
        opm = ops[mask]
        addr = (cols["b"][mask] + cols["c"][mask]) % (1 << 32)
        ab = word_decompose_np(addr)
        count_u8_word(record, ab)
        count(record, B.LTU, ab[:, 0] >> 2, 64, np.ones(n, dtype=np.int64))
        # access timestamp diffs
        act = cols["mem_act"][mask]
        assert np.all(act == 1), "memory instruction without memory access"
        ts = cols["clk"][mask]
        prev_clk = cols["mem_prev_clk"][mask]
        prev_shard = cols["mem_prev_shard"][mask]
        shard = record.public_values.shard
        compare = (prev_shard == shard).astype(np.int64)
        diff = np.where(compare == 1, ts - prev_clk - 1, shard - prev_shard - 1)
        count(record, B.U16Range, diff & 0xFFFF, 0, np.ones(n, dtype=np.int64))
        count(record, B.U8Range, diff >> 16, 0, np.ones(n, dtype=np.int64))
        # sign-extension MSB lookups
        mem = word_decompose_np(cols["mem_prev_value"][mask])
        i0 = (addr & 3).astype(np.int64)
        sel = mem[np.arange(n), i0]
        is_lb = (opm == int(Opcode.LB)).astype(np.int64)
        count(record, B.MSB, sel, 0, is_lb)
        half_hi = mem[np.arange(n), (addr & 2).astype(np.int64) + 1]
        is_lh = (opm == int(Opcode.LH)).astype(np.int64)
        count(record, B.MSB, half_hi, 0, is_lh)

    def num_rows(self, record):
        return count_rows(record, OPS)

    def generate_trace(self, record, output):
        cols, mask, ops = self._rows(record)
        n = int(mask.sum())
        w = COLS.writer(n)
        w.set("shard", np.full(n, record.public_values.shard))
        w.set("clk", cols["clk"][mask])
        for nm in ("pc", "next_pc", "next_next_pc"):
            w.set(nm, cols[nm][mask])
        for nm in ("a", "b", "c", "prev_a"):
            w.set_word(nm, cols[nm][mask])
        opm = ops[mask]
        for op, f in FLAGS.items():
            w.set(f, (opm == int(op)).astype(np.uint32))
        addr = (cols["b"][mask] + cols["c"][mask]) % (1 << 32)
        ab = word_decompose_np(addr)
        w.set_word("addr_word", addr)
        bb = word_decompose_np(cols["b"][mask])
        cb = word_decompose_np(cols["c"][mask])
        carries = np.zeros((n, 4), dtype=np.uint32)
        cur = np.zeros(n, dtype=np.int64)
        for i in range(4):
            s = bb[:, i].astype(np.int64) + cb[:, i] + cur
            cur = s >> 8
            carries[:, i] = cur
        w.set("a_carry", carries)
        l0 = (addr & 1).astype(np.uint32)
        l1 = ((addr >> 1) & 1).astype(np.uint32)
        w.set("l0", l0)
        w.set("l1", l1)
        ls = np.zeros((n, 4), dtype=np.uint32)
        ls[np.arange(n), (addr & 3).astype(np.int64)] = 1
        w.set("ls", ls)
        w.set("al0", ab[:, 0] >> 2)
        hs = (ab[:, 1].astype(np.int64) + ab[:, 2] + ab[:, 3]) % P
        w.set(
            "hi_sum_inv",
            np.array([pow(int(x), P - 2, P) if x else 0 for x in hs]),
        )
        mem = word_decompose_np(cols["mem_prev_value"][mask])
        i0 = (addr & 3).astype(np.int64)
        sel0 = mem[np.arange(n), i0]
        half_lo = mem[np.arange(n), (addr & 2).astype(np.int64)]
        half_hi = mem[np.arange(n), (addr & 2).astype(np.int64) + 1]
        is_half = np.isin(opm, [int(o) for o in _HALF_OPS])
        sel0 = np.where(is_half, half_lo, sel0)
        w.set("sel0", sel0)
        w.set("sel1", np.where(is_half, half_hi, 0))
        msb = np.zeros(n, dtype=np.uint32)
        lb = opm == int(Opcode.LB)
        lh = opm == int(Opcode.LH)
        msb[lb] = (mem[np.arange(n), i0][lb] >> 7) & 1
        msb[lh] = (half_hi[lh] >> 7) & 1
        w.set("msb_sel", msb)
        fill_access(w, cols_masked(cols, mask), "mem", "mem", 0, write=True,
                    shard=record.public_values.shard)
        w.set("is_real", np.ones(n))
        mat = pad_to_pow2(w.mat)
        mat[n:, COLS.slc("ls").start] = 1
        return mat

    def eval(self, b):
        L = COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        flags = {op: L[f] for op, f in FLAGS.items()}
        acc = 0
        for f in flags.values():
            b.assert_bool(f)
            acc = f + acc
        b.assert_eq(acc, is_real)
        opcode = sum(f * int(op) for op, f in flags.items())
        is_load = sum(flags[o] for o in OPS if o in LOAD_OPCODES)
        is_store_not_sc = sum(
            flags[o] for o in OPS if o in STORE_OPCODES and o != Opcode.SC
        )
        b.receive(
            LookupKind.Instruction,
            instruction_message(
                L["shard"], L["clk"], L["pc"], L["next_pc"], L["next_next_pc"],
                opcode, L.word("a"), L.word("b"), L.word("c"), L.word("prev_a"),
                is_store_not_sc, is_real, is_real, 0, is_real,
            ),
            is_real,
        )

        # address computation: addr = b + c (mod 2^32)
        aw, carry = L.word("addr_word"), L["a_carry"]
        bw, cw = L.word("b"), L.word("c")
        prev = 0
        for i in range(4):
            b.assert_bool(carry[i])
            b.assert_zero(bw[i] + cw[i] + prev - carry[i] * 256 - aw[i])
            prev = carry[i]
        send_u8_word(b, aw, is_real)
        # low bits and one-hot byte select
        l0, l1, ls, al0 = L["l0"], L["l1"], L["ls"], L["al0"]
        b.assert_bool(l0)
        b.assert_bool(l1)
        b.assert_eq(ls[0], (1 - l0) * (1 - l1))
        b.assert_eq(ls[1], l0 * (1 - l1))
        b.assert_eq(ls[2], (1 - l0) * l1)
        b.assert_eq(ls[3], l0 * l1)
        b.when(is_real).assert_eq(aw[0], al0 * 4 + l1 * 2 + l0)
        send_byte(b, B.LTU, al0, 64, 1, is_real)
        # address must be >= 256 (registers live below)
        hi_sum = aw[1] + aw[2] + aw[3]
        b.when(is_real).assert_zero(hi_sum * L["hi_sum_inv"] - 1)
        # alignment
        word_sel = sum(flags[o] for o in _WORD_OPS)
        half_sel = sum(flags[o] for o in _HALF_OPS)
        b.when(word_sel).assert_zero(l0)
        b.when(word_sel).assert_zero(l1)
        b.when(half_sel).assert_zero(l0)

        # the aligned memory access
        aligned_addr = pack_word(aw) - l0 - l1 * 2
        eval_access(
            b, L, "mem", L["shard"], L["clk"], aligned_addr, is_real, write=True
        )
        mem = L.word("mem_prev_value")
        val = L.word("mem_value")
        # loads leave memory unchanged
        for i in range(4):
            b.when(is_load).assert_eq(val[i], mem[i])

        a, prev_a = L.word("a"), L.word("prev_a")
        sel0, sel1, msb = L["sel0"], L["sel1"], L["msb_sel"]
        # byte/half selection helpers
        byte_sel = flags[Opcode.LB] + flags[Opcode.LBU]
        b.when(byte_sel).assert_eq(
            sel0, ls[0] * mem[0] + ls[1] * mem[1] + ls[2] * mem[2] + ls[3] * mem[3]
        )
        lh_sel = flags[Opcode.LH] + flags[Opcode.LHU]
        b.when(lh_sel).assert_eq(sel0, (1 - l1) * mem[0] + l1 * mem[2])
        b.when(lh_sel).assert_eq(sel1, (1 - l1) * mem[1] + l1 * mem[3])
        send_byte(b, B.MSB, sel0, 0, msb, flags[Opcode.LB])
        send_byte(b, B.MSB, sel1, 0, msb, flags[Opcode.LH])

        # -- load semantics -------------------------------------------------
        lwll = flags[Opcode.LW] + flags[Opcode.LL]
        for i in range(4):
            b.when(lwll).assert_eq(a[i], mem[i])
        b.when(byte_sel).assert_eq(a[0], sel0)
        for i in (1, 2, 3):
            b.when(flags[Opcode.LB]).assert_eq(a[i], 255 * msb)
            b.when(flags[Opcode.LBU]).assert_zero(a[i])
        b.when(lh_sel).assert_eq(a[0], sel0)
        b.when(lh_sel).assert_eq(a[1], sel1)
        for i in (2, 3):
            b.when(flags[Opcode.LH]).assert_eq(a[i], 255 * msb)
            b.when(flags[Opcode.LHU]).assert_zero(a[i])
        # LWL: a_j = mem_{j-(3-i)} if j >= 3-i else rt_j   (rt = prev_a)
        for j in range(4):
            expr = 0
            for i in range(4):
                src = j - (3 - i)
                expr = ls[i] * (mem[src] if src >= 0 else prev_a[j]) + expr
            b.when(flags[Opcode.LWL]).assert_eq(a[j], expr)
        # LWR: a_j = mem_{j+i} if j+i <= 3 else rt_j
        for j in range(4):
            expr = 0
            for i in range(4):
                src = j + i
                expr = ls[i] * (mem[src] if src <= 3 else prev_a[j]) + expr
            b.when(flags[Opcode.LWR]).assert_eq(a[j], expr)

        # -- store semantics ------------------------------------------------
        for i in range(4):
            b.when(flags[Opcode.SW]).assert_eq(val[i], a[i])
            b.when(flags[Opcode.SC]).assert_eq(val[i], prev_a[i])
        # SC writes 1 into rt
        b.when(flags[Opcode.SC]).assert_eq(a[0], 1)
        for i in (1, 2, 3):
            b.when(flags[Opcode.SC]).assert_zero(a[i])
        # SB: byte i replaced with rt_0
        for j in range(4):
            expr = 0
            for i in range(4):
                expr = ls[i] * (a[0] if i == j else mem[j]) + expr
            b.when(flags[Opcode.SB]).assert_eq(val[j], expr)
        # SH: half replaced
        b.when(flags[Opcode.SH]).assert_eq(val[0], (1 - l1) * a[0] + l1 * mem[0])
        b.when(flags[Opcode.SH]).assert_eq(val[1], (1 - l1) * a[1] + l1 * mem[1])
        b.when(flags[Opcode.SH]).assert_eq(val[2], l1 * a[0] + (1 - l1) * mem[2])
        b.when(flags[Opcode.SH]).assert_eq(val[3], l1 * a[1] + (1 - l1) * mem[3])
        # SWL: val_j = rt_{j+(3-i)} if j <= i else mem_j
        for j in range(4):
            expr = 0
            for i in range(4):
                src = j + (3 - i)
                expr = ls[i] * (a[src] if j <= i else mem[j]) + expr
            b.when(flags[Opcode.SWL]).assert_eq(val[j], expr)
        # SWR: val_j = rt_{j-i} if j >= i else mem_j
        for j in range(4):
            expr = 0
            for i in range(4):
                src = j - i
                expr = ls[i] * (a[src] if src >= 0 else mem[j]) + expr
            b.when(flags[Opcode.SWR]).assert_eq(val[j], expr)


def cols_masked(cols, mask):
    return {k: v[mask] for k, v in cols.items()}
