"""The reference's sha3-chain guest (zkvm-benchmarks `sha3-chain`), after the
port's tools/precompile_programs.py:keccak_chain_program: `rounds` rounds of
keccak256 over the previous 32-byte digest, one KECCAK_SPONGE call of one
block a round. The block is at 0x2000: 36 words, the 136-byte rate block
widened with two zero capacity words, its padding (byte 32: 0x01, byte 135:
0x80) stored once. The digest is at 0x4000 and the sponge's length word
(36) at 0x4040. The first message is read from stdin into the digest, so
the loop's copy absorbs it first (the port's program starts from 32 zero
bytes); the last digest's eight words are committed."""

from __future__ import annotations

from ..frozen.guest_asm import commit_words, loop
from .fib import hint_read


def build(asm, rounds: int):
    assert 0 < rounds < 0x8000
    O = asm.O
    before = [*hint_read(asm, 0x4000, 32),
              asm.imm(O.ADD, 8, 0, 0x2000), asm.imm(O.ADD, 10, 0, 0x4000),
              asm.imm(O.ADD, 9, 0, 1), asm.ri(O.SW, 9, 8, 4 * 8),  # byte 32: 0x01
              asm.imm(O.SLL, 9, 0x8000, 16), asm.ri(O.SW, 9, 8, 4 * 33),  # byte 135: 0x80
              asm.imm(O.ADD, 9, 0, 36), asm.ri(O.SW, 9, 10, 0x40)]  # 36 words
    body = []
    for j in range(8):  # the last digest is the message
        body += [asm.ri(O.LW, 9, 10, 4 * j), asm.ri(O.SW, 9, 8, 4 * j)]
    body += [asm.imm(O.SLL, 2, 0x0101, 16), asm.ri(O.OR, 2, 2, 0x09),  # KECCAK_SPONGE
             asm.imm(O.ADD, 4, 0, 0x2000), asm.imm(O.ADD, 5, 0, 0x4000),
             asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]
    return loop(asm, rounds, body, before, commit_words(asm, 10))


def inputs(rng, rounds: int) -> list:
    return [rng.integers(0, 256, 32, dtype="u1").tobytes()]
