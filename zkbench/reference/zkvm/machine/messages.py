"""Shared lookup message layouts between the CPU and instruction chips.

Instruction message (kind=Instruction), in order
(mirrors the reference's send_instruction, cpu/air/mod.rs:60-79):
  [shard_to_send, clk_to_send, pc, next_pc, next_next_pc, opcode,
   a0..a3, b0..b3, c0..c3, prev_a0..prev_a3,
   op_a_immutable, is_rw_a, is_check_memory, is_halt, is_sequential]

Program message (kind=Program):
  [pc, opcode, op_a, op_a_0, b0..b3, c0..c3, imm_b, imm_c]

PublicValues element indices (see executor/record.py PublicValues.to_list):
  digest bytes [0, 32), deferred [32, 40), start_pc 40, next_pc 41,
  exit_code 42, shard 43, execution_shard 44.
"""

PV_DIGEST = 0  # 32 byte elements
PV_DEFERRED = 32  # 8 field elements
PV_START_PC = 40
PV_NEXT_PC = 41
PV_EXIT_CODE = 42
PV_SHARD = 43
PV_EXECUTION_SHARD = 44
# memory init/finalize address chains, 32 little-endian bits each
# (reference air/public_values.rs:22-60; constrained by memory_global.py)
PV_PREV_INIT_ADDR = 45
PV_LAST_INIT_ADDR = 77
PV_PREV_FIN_ADDR = 109
PV_LAST_FIN_ADDR = 141


def instruction_message(
    shard_to_send,
    clk_to_send,
    pc,
    next_pc,
    next_next_pc,
    opcode,
    a_word,
    b_word,
    c_word,
    prev_a_word,
    op_a_immutable,
    is_rw_a,
    is_check_memory,
    is_halt,
    is_sequential,
    num_extra_cycles=0,
):
    return (
        [shard_to_send, clk_to_send, pc, next_pc, next_next_pc, opcode]
        + list(a_word)
        + list(b_word)
        + list(c_word)
        + list(prev_a_word)
        + [op_a_immutable, is_rw_a, is_check_memory, is_halt, is_sequential,
           num_extra_cycles]
    )


def program_message(pc, opcode, op_a, op_a_0, b_word, c_word, imm_b, imm_c):
    return [pc, opcode, op_a, op_a_0] + list(b_word) + list(c_word) + [imm_b, imm_c]
