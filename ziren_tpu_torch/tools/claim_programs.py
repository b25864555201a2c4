"""Guests of the composition path: programs that claim other zkVM proofs.

A guest claims a sub-proof with VERIFY_ZKM_PROOF(vkey digest, public-values
digest) and commits the fold of its claims with COMMIT_DEFERRED_PROOFS; the
recursion tree discharges the claims (recursion/deferred.py). The JAX
package's `executor/asm.py:deferred_claim_program` makes one claim;
`claims_program` makes any number, one after the other, and for one claim
builds the same words. It takes the `asm` module it builds with (this
package's `executor/asm.py`, or another package's copy of it), so that a test
can build the same instruction words on both sides of a comparison:

    from ziren_tpu_torch.executor import asm
    from ziren_tpu_torch.recursion import deferred as D
    claim = (D.claim_vk_digest(sub_vk), committed_value_digest_words)
    folded = D.fold_claims([(claim[0], digest_bytes(claim[1]))] * 2)
    program = claims_program(asm, [claim, claim], folded)
"""

from __future__ import annotations

VKEY_ADDR, PV_DIGEST_ADDR = 0x2000, 0x2100
VERIFY_ZKM_PROOF, COMMIT_DEFERRED_PROOFS = 0x1B, 0x1A


def _store(asm, words, offset):
    """The words at VKEY_ADDR + offset, one SW each (r8 holds VKEY_ADDR)."""
    out = []
    for i, w in enumerate(words):
        w = int(w)
        out += [asm.imm(asm.O.SLL, 9, w >> 16, 16), asm.ri(asm.O.OR, 9, 9, w & 0xFFFF),
                asm.ri(asm.O.SW, 9, 8, offset + 4 * i)]
    return out


def claims_program(asm, claims, digest_words):
    """A guest that makes one VERIFY_ZKM_PROOF a claim, in order, each claim
    (vkey digest words, pv digest words) written to the same two buffers,
    then commits the eight words of `digest_words` (the host fold of the
    claims) as its deferred-proofs digest, and halts with code 0."""
    O, imm = asm.O, asm.imm
    insns = [imm(O.ADD, 8, 0, VKEY_ADDR)]
    for vkey_words, pvd_words in claims:
        insns += _store(asm, vkey_words, 0)
        insns += _store(asm, pvd_words, PV_DIGEST_ADDR - VKEY_ADDR)
        insns += [imm(O.ADD, 2, 0, VERIFY_ZKM_PROOF), imm(O.ADD, 4, 0, VKEY_ADDR),
                  imm(O.ADD, 5, 0, PV_DIGEST_ADDR),
                  asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]
    for i, w in enumerate(digest_words):
        w = int(w)
        insns += [imm(O.ADD, 2, 0, COMMIT_DEFERRED_PROOFS), imm(O.ADD, 4, 0, i),
                  imm(O.SLL, 5, w >> 16, 16), asm.ri(O.OR, 5, 5, w & 0xFFFF),
                  asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]
    insns += [*asm.halt_sequence(0)]
    return asm.Program.new(insns)


def digest_bytes(words) -> list:
    """Eight little-endian u32 words -> the 32 byte-felts of a public-values
    digest (the inverse of recursion/deferred.py:pv_digest_bytes_to_words)."""
    return [(int(w) >> (8 * i)) & 0xFF for w in words for i in range(4)]
