"""The reference's sha2-chain guest (zkvm-benchmarks `sha2-chain`), after the
port's tools/precompile_programs.py:sha256_chain_program: `rounds` rounds of
SHA-256 over the previous 32-byte digest through SHA_EXTEND and
SHA_COMPRESS, the message schedule at 0x2000 (its padding words 8..15
stored once), the state at 0x3000, set to the IV each round after its digest
is copied into the message. The first message is read from stdin into the
state (the port's program starts from 32 zero bytes); the last digest's
eight words are committed."""

from __future__ import annotations

from ..frozen.guest_asm import commit_words, loop, store_words
from .fib import hint_read

SHA256_IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
             0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
PAD = [0x80000000, 0, 0, 0, 0, 0, 0, 256]  # one 32-byte message: w[8..15]


def build(asm, rounds: int):
    assert 0 < rounds < 0x8000
    O = asm.O
    before = [*hint_read(asm, 0x3000, 32), asm.imm(O.ADD, 8, 0, 0x2000),
              asm.imm(O.ADD, 10, 0, 0x3000), *store_words(asm, 8, 32, PAD)]
    body = []
    for j in range(8):  # the last digest is the message
        body += [asm.ri(O.LW, 9, 10, 4 * j), asm.ri(O.SW, 9, 8, 4 * j)]
    body += store_words(asm, 10, 0, SHA256_IV)
    body += [asm.imm(O.SLL, 2, 0x3001, 16), asm.ri(O.OR, 2, 2, 0x05),  # SHA_EXTEND
             asm.imm(O.ADD, 4, 0, 0x2000), asm.Instruction(O.SYSCALL, 2, 4, 5, False, False),
             asm.imm(O.SLL, 2, 0x0101, 16), asm.ri(O.OR, 2, 2, 0x06),  # SHA_COMPRESS
             asm.imm(O.ADD, 4, 0, 0x2000), asm.imm(O.ADD, 5, 0, 0x3000),
             asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]
    return loop(asm, rounds, body, before, commit_words(asm, 10))


def inputs(rng, rounds: int) -> list:
    return [rng.integers(0, 256, 32, dtype="u1").tobytes()]
