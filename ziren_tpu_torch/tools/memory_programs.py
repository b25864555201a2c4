"""Guests of two paths that the JAX package's tests prove: standalone
memory shards (memory_sweep_program) and unconstrained blocks with the hint
stream (unconstrained_program).

Once the addresses an execution touches pass `combine_memory_threshold`
(executor/split.py:finalize_memory, 2^14 at every RAM tier), their init and
finalize events leave the last execution shard for memory shards that hold
no Cpu. fibonacci touches a few dozen addresses; `memory_sweep_program`
touches as many as it is asked to. It takes the `asm` module it builds with
(this package's `executor/asm.py`, or another package's copy of it), as each
builder here does, so that a test can build the same instruction words on
both sides of a comparison:

    from ziren_tpu_torch.executor import asm
    from ziren_tpu_torch.executor.split import SplitOpts
    n = SplitOpts.from_env().combine_memory_threshold + 4096
    program = memory_sweep_program(asm, n)
"""

from __future__ import annotations

BASE, SEED, STEP = 0x10000, 0x9E3779B9, 0x01000193
UNROLL = 4  # words a loop turn


def sweep_fold(n_words: int) -> int:
    """The fold of every word loaded back: the sum mod 2^32 of the words
    SEED + i * STEP (mod 2^32) that the program stores at BASE + 4 * i."""
    return sum((SEED + i * STEP) & 0xFFFFFFFF for i in range(n_words)) & 0xFFFFFFFF


def memory_sweep_program(asm, n_words: int):
    """A guest that stores `n_words` distinct words at BASE, BASE + 4, ...,
    loads each back, adds it into r11, checks r11 against the fold the host
    computes (sweep_fold), commits r11 as public word 0 and halts with code
    0; with another fold it halts with code 1. Each word is loaded back in
    the loop turn that stored it, so that each address is one local memory
    segment, in one shard: the Global chip, whose trace costs the host most,
    gets two rows an address in the execution shards and two in the memory
    shards. n_words is a multiple of UNROLL."""
    if n_words <= 0 or n_words % UNROLL:
        raise ValueError(f"n_words must be a positive multiple of {UNROLL}: {n_words}")
    O, imm, ri, rr = asm.O, asm.imm, asm.ri, asm.rr
    insns = [
        imm(O.ADD, 8, 0, BASE),  # r8: the next address
        imm(O.ADD, 9, 0, n_words // UNROLL),  # r9: loop turns left
        imm(O.ADD, 10, 0, SEED),  # r10: the next word
        imm(O.ADD, 11, 0, 0),  # r11: the fold
    ]
    loop = 4 * len(insns)
    for k in range(UNROLL):
        insns += [
            ri(O.SW, 10, 8, 4 * k),
            ri(O.LW, 12, 8, 4 * k),
            rr(O.ADD, 11, 11, 12),
            ri(O.ADD, 10, 10, STEP),
        ]
    insns += [ri(O.ADD, 8, 8, 4 * UNROLL), ri(O.SUB, 9, 9, 1)]
    branch = 4 * len(insns)
    insns += [ri(O.BGTZ, 9, 0, (loop - (branch + 4)) & 0xFFFFFFFF), asm.NOP]
    insns += [imm(O.ADD, 13, 0, sweep_fold(n_words))]
    check = 4 * len(insns)
    fail = asm.halt_sequence(1)
    ok = check + 8 + 4 * len(fail)
    insns += [asm.Instruction(O.BEQ, 11, 13, (ok - (check + 4)) & 0xFFFFFFFF, False, True),
              asm.NOP, *fail]
    insns += [
        imm(O.ADD, 2, 0, 0x10),  # COMMIT word 0 = the fold
        imm(O.ADD, 4, 0, 0),
        ri(O.ADD, 5, 11, 0),
        asm.Instruction(O.SYSCALL, 2, 4, 5, False, False),
        *asm.halt_sequence(0),
    ]
    return asm.Program.new(insns)


def unconstrained_program(asm):
    """tests/test_unconstrained.py's program: an ENTER_UNCONSTRAINED whose
    block stores 42 at 0x2000, writes it to the hint fd and leaves with
    EXIT_UNCONSTRAINED, which reverts all but the hint stream and replays the
    ENTER returning 0, so that the branch after it skips the block; then
    HINT_LEN into r21 (4), HINT_READ to 0x5000 and a load of it into r20
    (42), and a halt with code 0."""
    O, imm, ri, Instruction = asm.O, asm.imm, asm.ri, asm.Instruction
    insns = [imm(O.ADD, 2, 0, 3), Instruction(O.SYSCALL, 2, 4, 5, False, False)]
    beq_idx = len(insns)
    insns += [None, None]
    block = [
        imm(O.ADD, 9, 0, 42),
        imm(O.ADD, 8, 0, 0x2000),
        ri(O.SW, 9, 8, 0),
        imm(O.ADD, 2, 0, 2),  # WRITE to the hint fd
        imm(O.ADD, 4, 0, 4),
        imm(O.ADD, 5, 0, 0x2000),
        imm(O.ADD, 6, 0, 4),
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        imm(O.ADD, 2, 0, 4),  # EXIT_UNCONSTRAINED
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
    ]
    after = [
        imm(O.ADD, 2, 0, 0xF0),  # HINT_LEN
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ri(O.ADD, 21, 2, 0),
        imm(O.ADD, 2, 0, 0xF1),  # HINT_READ
        imm(O.ADD, 4, 0, 0x5000),
        imm(O.ADD, 5, 0, 4),
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        imm(O.ADD, 8, 0, 0x5000),
        ri(O.LW, 20, 8, 0),
        *asm.halt_sequence(0),
    ]
    target_pc = (2 + 2 + len(block)) * 4
    insns[beq_idx] = Instruction(O.BEQ, 2, 0, (target_pc - 12) & 0xFFFFFFFF, False, True)
    insns[beq_idx + 1] = imm(O.ADD, 0, 0, 0)
    return asm.Program.new(insns[: beq_idx + 2] + block + after)
