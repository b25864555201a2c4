"""CpuChip: one row per cycle — program fetch, operand register IO, pc/clk
chaining, public-value binding, and the uniform instruction dispatch lookup
(reference: crates/core/machine/src/cpu/{air,columns}).
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import (
    ALU_OPCODES,
    BRANCH_OPCODES,
    JUMP_OPCODES,
    LOAD_OPCODES,
    MEM_OPCODES,
    MISC_OPCODES,
    Opcode,
    STORE_OPCODES,
)
from ..executor.opcode import ByteOpcode as B
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .layout import Layout, pad_to_pow2, word_decompose_np
from .memory_access import POS_A, POS_B, POS_C, add_access_cols, eval_access, fill_access
from .messages import (
    PV_EXECUTION_SHARD,
    PV_NEXT_PC,
    PV_START_PC,
    instruction_message,
    program_message,
)

COLS = (
    Layout()
    .add("shard")
    .add("clk16")
    .add("clk8")
    .add("pc")
    .add("next_pc")
    .add("next_next_pc")
    # instruction (mirrors the preprocessed program row)
    .add("opcode")
    .add("op_a")
    .add("op_a_0")
    .word("op_b")
    .word("op_c")
    .add("imm_b")
    .add("imm_c")
    # dispatch flags (validated by the receiving instruction chips)
    .add("op_a_immutable")
    .add("is_rw_a")
    .add("is_check_memory")
    .add("is_halt")
    .add("is_sequential")
    .add("shard_to_send")
    .add("clk_to_send")
    .add("num_extra_cycles")
    # operand values
    .word("a")
    .word("prev_a")  # hi_or_prev_a
    .word("b")
    .word("c")
    .add("is_real")
)
add_access_cols(COLS, "a_acc", write=True)
add_access_cols(COLS, "b_acc", write=False)
add_access_cols(COLS, "c_acc", write=False)

# opcode family -> (op_a_immutable, is_rw_a, is_sequential)
_RW_A_OPS = (
    {Opcode.SYSCALL, Opcode.INS, Opcode.MADDU, Opcode.MSUBU, Opcode.MADD, Opcode.MSUB,
     Opcode.MEQ, Opcode.MNE}
    | MEM_OPCODES
)
_IMMUTABLE_OPS = BRANCH_OPCODES | (STORE_OPCODES - {Opcode.SC}) | {Opcode.TEQ}


class CpuChip(Air):
    # Picus determinism i/o: instruction context + operand witnesses are
    # free; the written a value and timestamps-to-send are derived
    picus_inputs = ("shard", "clk16", "clk8", "pc", "next_pc",
                    "next_next_pc", "opcode", "op_a", "op_a_0", "op_b",
                    "op_c", "imm_b", "imm_c", "op_a_immutable", "is_rw_a",
                    "is_check_memory", "is_halt", "is_sequential",
                    "num_extra_cycles", "b", "c", "prev_a", "is_real")
    picus_outputs = ("a", "shard_to_send", "clk_to_send")
    name = "Cpu"
    cycle_chip = True
    width = COLS.width

    def generate_dependencies(self, record, output):
        cols = record.freeze()
        n = record.num_cycles
        shard = record.public_values.shard
        ones = np.ones(n, dtype=np.int64)
        # clk limbs
        clk = cols["clk"]
        count(record, B.U16Range, clk & 0xFFFF, 0, ones)
        count(record, B.U8Range, clk >> 16, 0, ones)
        count(record, B.U16Range, np.full(n, shard, dtype=np.int64), 0, ones)
        # access diff limbs
        for pos_name, position in (("a", POS_A), ("b", POS_B), ("c", POS_C)):
            act = cols[f"{pos_name}_act"]
            prev_clk = cols[f"{pos_name}_prev_clk"]
            prev_shard = cols[f"{pos_name}_prev_shard"]
            ts = clk + position
            compare = (prev_shard == shard).astype(np.int64) * act
            diff = (
                np.where(compare == 1, ts - prev_clk - 1, shard - prev_shard - 1)
                * act
            )
            count(record, B.U16Range, diff & 0xFFFF, 0, act)
            count(record, B.U8Range, diff >> 16, 0, act)
        # op_a value range check (the access value, i.e. 0 for r0 writes)
        a_val = word_decompose_np(cols["a_value"])
        count_u8_word(record, a_val, ones)

    def num_rows(self, record):
        return record.num_cycles

    def generate_trace(self, record, output):
        cols = record.freeze()
        n = record.num_cycles
        w = COLS.writer(n)
        prog = record.program
        instrs = prog.instructions
        idx = cols["instr_idx"]
        opcode = np.array([int(instrs[i].opcode) for i in idx], dtype=np.int64)
        w.set("shard", np.full(n, record.public_values.shard))
        w.set("clk16", cols["clk"] & 0xFFFF)
        w.set("clk8", cols["clk"] >> 16)
        w.set("pc", cols["pc"])
        w.set("next_pc", cols["next_pc"])
        w.set("next_next_pc", cols["next_next_pc"])
        w.set("opcode", opcode)
        w.set("op_a", np.array([instrs[i].op_a for i in idx]))
        w.set("op_a_0", np.array([int(instrs[i].op_a == 0) for i in idx]))
        w.set_word("op_b", np.array([instrs[i].op_b for i in idx], dtype=np.uint32))
        w.set_word("op_c", np.array([instrs[i].op_c for i in idx], dtype=np.uint32))
        w.set("imm_b", np.array([int(instrs[i].imm_b) for i in idx]))
        w.set("imm_c", np.array([int(instrs[i].imm_c) for i in idx]))
        ops = [instrs[i].opcode for i in idx]
        w.set("op_a_immutable", np.array([int(o in _IMMUTABLE_OPS) for o in ops]))
        w.set("is_rw_a", np.array([int(o in _RW_A_OPS) for o in ops]))
        _CHK = MEM_OPCODES | {
            Opcode.MULT, Opcode.MULTU, Opcode.DIV, Opcode.DIVU,
            Opcode.MADD, Opcode.MADDU, Opcode.MSUB, Opcode.MSUBU,
            Opcode.SYSCALL,
        }
        is_chk = np.array([int(o in _CHK) for o in ops])
        w.set("is_check_memory", is_chk)
        sid_arr = np.asarray(cols["syscall_code"])
        is_halt = ((sid_arr == 0) | (sid_arr == 4246)) & (
            np.array([int(o == Opcode.SYSCALL) for o in ops]) == 1
        )  # HALT and SYS_EXT_GROUP both end execution (next_pc = 0)
        w.set("is_halt", is_halt.astype(np.int64))
        w.set("is_sequential", np.array(
            [int(o not in BRANCH_OPCODES and o not in JUMP_OPCODES) for o in ops]
        ))
        w.set("shard_to_send", is_chk * record.public_values.shard)
        w.set("clk_to_send", is_chk * cols["clk"])
        # extra cycles: sha_extend = 48; every other precompile that writes
        # at clk + 1 costs one extra cycle (doubles write at clk: zero)
        is_syscall = np.array([int(o == Opcode.SYSCALL) for o in ops])
        sid = np.asarray(cols["syscall_code"])
        one_cycle = [
            0x00010030, 0x01010006, 0x0101001D, 0x01010009,  # p2/shac/u256/keccak
            0x0101000A, 0x0101002C, 0x0101000E, 0x0101001E,  # ec adds
            0x01010007,  # ed add
            0x01010020, 0x01010021, 0x01010022, 0x01010023,  # bls fp/fp2
            0x01010024, 0x01010025,
            0x01010026, 0x01010027, 0x01010028, 0x01010029,  # bn254 fp/fp2
            0x0101002A, 0x0101002B,
            0x0101002F,  # u256x2048 mul
        ]
        extra = (sid == 0x30010005) * 48
        for c in one_cycle:
            extra = extra + (sid == c) * 1
        extra = extra * is_syscall
        w.set("num_extra_cycles", extra.astype(np.int64))
        w.set_word("a", cols["a"])
        w.set_word("prev_a", cols["prev_a"])
        w.set_word("b", cols["b"])
        w.set_word("c", cols["c"])
        w.set("is_real", np.ones(n))
        for pos_name, prefix, position, write in (
            ("a", "a_acc", POS_A, True),
            ("b", "b_acc", POS_B, False),
            ("c", "c_acc", POS_C, False),
        ):
            fill_access(
                w, cols, pos_name, prefix, position, write,
                shard=record.public_values.shard,
            )
        mat = pad_to_pow2(w.mat)
        # padding rows: imm_b = imm_c = 1 so operand accesses are disabled
        if mat.shape[0] > n:
            mat[n:, COLS.idx("imm_b")] = 1
            mat[n:, COLS.idx("imm_c")] = 1
        return mat

    def eval(self, b):
        L = COLS.view(b.main_local)
        N = COLS.view(b.main_next)
        pv = b.public_values
        is_real = L["is_real"]
        not_real = 1 - is_real

        # is_real flag behavior
        b.assert_bool(is_real)
        b.when_first_row().assert_one(is_real)
        b.when_transition().when(not_real).assert_zero(N["is_real"])
        b.when_transition().when(L["is_halt"]).assert_zero(N["is_real"])
        b.when(not_real).assert_one(L["imm_b"])
        b.when(not_real).assert_one(L["imm_c"])

        # shard and clk
        clk = L["clk16"] + L["clk8"] * 65536
        next_clk = N["clk16"] + N["clk8"] * 65536
        b.when(is_real).assert_eq(L["shard"], pv[PV_EXECUTION_SHARD])
        b.when_transition().when(N["is_real"]).assert_eq(L["shard"], N["shard"])
        send_byte(b, B.U16Range, L["shard"], 0, 0, is_real)
        b.when_first_row().assert_zero(clk)
        b.when_transition().when(N["is_real"]).assert_eq(
            clk + 5 + L["num_extra_cycles"], next_clk
        )
        send_byte(b, B.U16Range, L["clk16"], 0, 0, is_real)
        send_byte(b, B.U8Range, L["clk8"], 0, 0, is_real)

        # program fetch
        b.send(
            LookupKind.Program,
            program_message(
                L["pc"], L["opcode"], L["op_a"], L["op_a_0"],
                L.word("op_b"), L.word("op_c"), L["imm_b"], L["imm_c"],
            ),
            is_real,
        )

        # operand registers
        for i in range(4):
            b.when(L["imm_b"]).assert_eq(L.word("b")[i], L.word("op_b")[i])
            b.when(L["imm_c"]).assert_eq(L.word("c")[i], L.word("op_c")[i])
        eval_access(
            b, L, "b_acc", L["shard"], clk + POS_B, L.word("op_b")[0],
            1 - L["imm_b"], write=False,
        )
        eval_access(
            b, L, "c_acc", L["shard"], clk + POS_C, L.word("op_c")[0],
            1 - L["imm_c"], write=False,
        )
        for i in range(4):
            b.when(1 - L["imm_b"]).assert_eq(L.word("b")[i], L.word("b_acc_value")[i])
            b.when(1 - L["imm_c"]).assert_eq(L.word("c")[i], L.word("c_acc_value")[i])

        # op_a access (always evaluated)
        a_val = L.word("a_acc_value")
        for i in range(4):
            b.when(L["op_a_0"]).assert_zero(a_val[i])
            b.when(1 - L["op_a_0"]).assert_eq(L.word("a")[i], a_val[i])
            b.when(L["is_rw_a"]).assert_eq(
                L.word("prev_a")[i], L.word("a_acc_prev_value")[i]
            )
            b.when(L["op_a_immutable"]).assert_eq(
                L.word("a")[i], L.word("a_acc_prev_value")[i]
            )
        eval_access(
            b, L, "a_acc", L["shard"], clk + POS_A, L["op_a"], is_real, write=True
        )
        send_u8_word(b, a_val, is_real)

        # instruction dispatch
        b.when(is_real).assert_eq(
            L["shard_to_send"], L["is_check_memory"] * L["shard"]
        )
        b.when(is_real).assert_eq(L["clk_to_send"], L["is_check_memory"] * clk)
        b.send(
            LookupKind.Instruction,
            instruction_message(
                L["shard_to_send"], L["clk_to_send"], L["pc"], L["next_pc"],
                L["next_next_pc"], L["opcode"], L.word("a"), L.word("b"),
                L.word("c"), L.word("prev_a"), L["op_a_immutable"], L["is_rw_a"],
                L["is_check_memory"], L["is_halt"], L["is_sequential"],
                L["num_extra_cycles"],
            ),
            is_real,
        )

        # pc chaining and public values
        b.when_first_row().assert_eq(pv[PV_START_PC], L["pc"])
        b.when_first_row().when(1 - L["is_halt"]).assert_eq(L["pc"] + 4, L["next_pc"])
        b.when_transition().when(N["is_real"]).assert_eq(L["next_pc"], N["pc"])
        b.when_transition().when(N["is_real"]).when(1 - N["is_halt"]).assert_eq(
            L["next_next_pc"], N["next_pc"]
        )
        b.when_transition().when(is_real).when(L["is_sequential"]).assert_eq(
            L["next_next_pc"], L["next_pc"] + 4
        )
        b.when_transition().when(is_real - N["is_real"]).assert_eq(
            pv[PV_NEXT_PC], L["next_pc"]
        )
        b.when_last_row().when(is_real).assert_eq(pv[PV_NEXT_PC], L["next_pc"])
