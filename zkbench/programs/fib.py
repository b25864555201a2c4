"""The reference's fibonacci guest (zkvm-benchmarks `fibonacci`), after the
port's executor/asm.py:fibonacci_program: an iterative loop in registers,
six instructions a step, whose last value is committed. The starting pair
(a, b) is read from stdin, so that each request proves its own execution;
the port's program starts from (0, 1).

    r8 = 0x5000; HINT_READ 8 bytes there; a = [r8]; b = [r8 + 4]
    n times: t = a + b; a = b; b = t
    COMMIT word 0 = b; halt
"""

from __future__ import annotations

from ..frozen.guest_asm import loop

HINT_AT = 0x5000


def hint_read(asm, addr: int, nbytes: int) -> list:
    """HINT_READ the next stdin buffer (nbytes long) to addr."""
    O = asm.O
    return [asm.imm(O.ADD, 2, 0, 0xF1), asm.imm(O.ADD, 4, 0, addr),
            asm.imm(O.ADD, 5, 0, nbytes), asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]


def build(asm, n: int):
    O = asm.O
    before = [*hint_read(asm, HINT_AT, 8), asm.imm(O.ADD, 8, 0, HINT_AT),
              asm.ri(O.LW, 9, 8, 0), asm.ri(O.LW, 10, 8, 4)]
    body = [asm.rr(O.ADD, 12, 9, 10), asm.ri(O.ADD, 9, 10, 0), asm.ri(O.ADD, 10, 12, 0)]
    after = [asm.imm(O.ADD, 2, 0, 0x10), asm.imm(O.ADD, 4, 0, 0), asm.ri(O.ADD, 5, 10, 0),
             asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]
    return loop(asm, n, body, before, after)


def inputs(rng, n: int) -> list:
    return [rng.integers(0, 1 << 32, 2, dtype="<u4").tobytes()]
