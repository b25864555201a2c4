"""Helpers of the guest builders, copied from
ziren_tpu_torch/tools/precompile_programs.py at commit 88d1ffc (`_store_words`,
`_loop`, `_commit_words`; the copies drop the leading underscore).

Every builder takes the `asm` module it builds with (the port's
executor/asm.py, or the reference's copy of it), so that both sides of the
comparison build the same instruction words."""

from __future__ import annotations


def store_words(asm, base_reg, offset, words) -> list:
    O = asm.O
    insns = []
    for i, w in enumerate(words):
        insns += [asm.imm(O.SLL, 9, w >> 16, 16), asm.ri(O.OR, 9, 9, w & 0xFFFF),
                  asm.ri(O.SW, 9, base_reg, offset + 4 * i)]
    return insns


def loop(asm, n: int, body: list, before: list, after: list):
    """before; r11 = n; do { body } while (--r11 > 0); after; halt."""
    O = asm.O
    head = before + [asm.imm(O.ADD, 11, 0, n)]
    start = 4 * len(head)
    insns = head + body + [asm.ri(O.SUB, 11, 11, 1)]
    branch_pc = 4 * len(insns)
    insns += [asm.ri(O.BGTZ, 11, 0, (start - (branch_pc + 4)) & 0xFFFFFFFF), asm.NOP]
    return asm.Program.new(insns + after + asm.halt_sequence(0))


def commit_words(asm, base_reg) -> list:
    """COMMIT the eight words at base_reg as the committed digest."""
    O = asm.O
    insns = []
    for j in range(8):
        insns += [asm.ri(O.LW, 5, base_reg, 4 * j), asm.imm(O.ADD, 2, 0, 0x10),
                  asm.imm(O.ADD, 4, 0, j), asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]
    return insns
