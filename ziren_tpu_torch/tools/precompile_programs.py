"""Workloads of the precompile path: programs that call every precompile
chip of the MIPS machine, and two hash chains after the reference's
published sha2-chain and sha3-chain workloads.

Every builder takes the `asm` module it builds with (this package's
`executor/asm.py`, or another package's copy of it), so that a test can
build the same instruction words on both sides of a comparison:

    from ziren_tpu_torch.executor import asm
    program = group_program(asm, "hash")
    program, digest = sha256_chain_program(asm, 230)

`group_program` runs the single-precompile builders of `asm` one after the
other, each without its halt sequence, and halts once at the end. The four
groups (`GROUPS`) cover the 35 chips of `PRECOMPILE_CHIPS` between them.
The chains commit their final digest as the eight words of the public
values' committed digest (`committed_digest` reads it back).
"""

from __future__ import annotations

import hashlib

from ..executor.keccak import keccakf

PBN = 21888242871839275222246405745257275088696311157297823662689037894645226208583
PBLS = int("1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
           "1eabfffeb153ffffb9feffffffffaaab", 16)

# the operands of the Fp / Fp2 tower's tests; 0x23 / 0x24 take the Fp2 ones of 0x25
_XA, _YA = 3**150 % PBN, 7**140 % PBN
_A0, _A1, _B0, _B1 = 3**99 % PBN, 5**99 % PBN, 7**99 % PBN, 11**99 % PBN
_XB, _YB = 3**200 % PBLS, 7**200 % PBLS
_C0, _C1, _D0, _D1 = 3**77 % PBLS, 5**77 % PBLS, 7**77 % PBLS, 11**77 % PBLS
FP_CASES = [  # (syscall low byte, x, y, words an operand)
    (0x20, _XB, _YB, 12), (0x21, _XB, _YB, 12), (0x22, _XB, _YB, 12),
    *[(lo, _C0 | (_C1 << 384), _D0 | (_D1 << 384), 24) for lo in (0x23, 0x24, 0x25)],
    (0x26, _XA, _YA, 8), (0x27, _XA, _YA, 8), (0x28, _XA, _YA, 8),
    *[(lo, _A0 | (_A1 << 256), _B0 | (_B1 << 256), 16) for lo in (0x29, 0x2A, 0x2B)],
]

# the SysLinux calls (number, a0, a1) of the chip's own oracle test
LINUX_CALLS = [
    (4045, 0x10000, 0), (4045, 0, 0), (4090, 0, 0x1801), (4090, 0x8000, 0x10),
    (4120, 0, 0), (4055, 1, 3), (4055, 2, 1), (4055, 9, 3), (4003, 0, 0), (4003, 5, 0),
    (4222, 0, 0),
]

# the chips that a fibonacci shard leaves out, by the group that proves them
GROUP_CHIPS = {
    "hash": ["SyscallCore", "SyscallPrecompile", "Poseidon2Permute", "ShaExtend",
             "ShaCompress", "Uint256Mul", "KeccakSponge", "U256xU2048Mul"],
    "weierstrass": [f"{c}{op}" for c in ("Secp256k1", "Secp256r1", "Bn254", "Bls12381")
                    for op in ("Add", "Double")]
    + ["Secp256k1Decompress", "Secp256r1Decompress", "Bls12381Decompress"],
    "edwards_fp": ["EdAdd", "EdDecompress"]
    + [f"{p}{op}" for p in ("Bls12381Fp", "Bls12381Fp2", "Bn254Fp", "Bn254Fp2")
       for op in ("Add", "Sub", "Mul")],
    "syscalls": ["SysLinux", "BooleanCircuitGarble"],
}
GROUPS = tuple(GROUP_CHIPS)
PRECOMPILE_CHIPS = [c for chips in GROUP_CHIPS.values() for c in chips]


def _body(program) -> list:
    """A builder's instructions without its halt sequence (the last three)."""
    return list(program.instructions[:-3])


def _syscall(asm, num, a0, a1) -> list:
    O = asm.O
    return [asm.imm(O.ADD, 2, 0, num), asm.imm(O.ADD, 4, 0, a0), asm.imm(O.ADD, 5, 0, a1),
            asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]


def _store_words(asm, base_reg, offset, words) -> list:
    O = asm.O
    insns = []
    for i, w in enumerate(words):
        insns += [asm.imm(O.SLL, 9, w >> 16, 16), asm.ri(O.OR, 9, 9, w & 0xFFFF),
                  asm.ri(O.SW, 9, base_reg, offset + 4 * i)]
    return insns


def _garble(asm) -> list:
    """BOOLEAN_CIRCUIT_GARBLE over three gates (an AND and an OR that match
    their ciphertexts, an AND that does not); the result word goes to r20."""
    O = asm.O
    delta = [0xAAAA0001, 0xBBBB0002, 0xCCCC0003, 0xDDDD0004]
    h0, h1, lb = [11, 22, 33, 44], [55, 66, 77, 88], [99, 111, 122, 133]
    and_ct = [h0[i] ^ h1[i] ^ lb[i] for i in range(4)]
    or_ct = [and_ct[i] ^ delta[i] for i in range(4)]
    bad_ct = list(and_ct)
    bad_ct[2] ^= 0x40
    words = [3] + delta
    for gtype, ct in ((0, and_ct), (1, or_ct), (0, bad_ct)):
        words += [gtype] + h0 + h1 + lb + ct
    return [
        asm.imm(O.ADD, 8, 0, 0x2000), *_store_words(asm, 8, 0, words),
        asm.imm(O.SLL, 2, 0x0001, 16), asm.ri(O.OR, 2, 2, 0x31),
        asm.imm(O.ADD, 4, 0, 0x2000), asm.imm(O.ADD, 5, 0, 0x4000),
        asm.Instruction(O.SYSCALL, 2, 4, 5, False, False),
        asm.imm(O.ADD, 10, 0, 0x4000), asm.ri(O.LW, 20, 10, 0),
    ]


def group_program(asm, name: str):
    """The grouped program `name` (one of GROUPS), built with `asm`."""
    if name == "hash":
        parts = [asm.poseidon2_program(), asm.sha256_program(), asm.keccak_program(b"x" * 200),
                 asm.uint256_program(3**150 % (1 << 256), 7**90, (1 << 255) - 19),
                 asm.u256x2048_program(3**160, 7**700 % (1 << 2048))]
        insns = [i for p in parts for i in _body(p)]
    elif name == "weierstrass":
        parts = [asm.ec_program(c, op) for c in ("secp256k1", "secp256r1", "bn254", "bls12381")
                 for op in ("add", "double")]
        parts += [asm.wdecompress_program(c) for c in ("secp256k1", "secp256r1", "bls12381")]
        insns = [i for p in parts for i in _body(p)]
    elif name == "edwards_fp":
        parts = [asm.ed25519_program(), asm.ed_decompress_program()]
        parts += [asm.fp_op_program(0x0101, lo, x, y, nw) for lo, x, y, nw in FP_CASES]
        insns = [i for p in parts for i in _body(p)]
    elif name == "syscalls":
        insns = [i for c in LINUX_CALLS for i in _syscall(asm, *c)] + _garble(asm)
    else:
        raise ValueError(f"unknown group {name!r}; the groups are {GROUPS}")
    return asm.Program.new(insns + asm.halt_sequence(0))


def multi_poseidon2_program(asm, k: int):
    """k POSEIDON2_PERMUTE calls on one state at 0x2000, with a load of the
    state between calls (the program of the precompile-split tests)."""
    O = asm.O
    insns = [asm.imm(O.ADD, 8, 0, 0x2000), asm.imm(O.ADD, 9, 0, 7),
             asm.ri(O.SW, 9, 8, 0), asm.ri(O.SW, 9, 8, 60)]
    for _ in range(k):
        insns += [asm.imm(O.SLL, 2, 1, 16), asm.ri(O.OR, 2, 2, 0x30),
                  asm.imm(O.ADD, 4, 0, 0x2000),
                  asm.Instruction(O.SYSCALL, 2, 4, 5, False, False),
                  asm.ri(O.LW, 20, 8, 0)]
    return asm.Program.new(insns + asm.halt_sequence(0))


def _loop(asm, n: int, body: list, before: list, after: list):
    """before; r11 = n; do { body } while (--r11 > 0); after; halt."""
    O = asm.O
    head = before + [asm.imm(O.ADD, 11, 0, n)]
    start = 4 * len(head)
    insns = head + body + [asm.ri(O.SUB, 11, 11, 1)]
    branch_pc = 4 * len(insns)
    insns += [asm.ri(O.BGTZ, 11, 0, (start - (branch_pc + 4)) & 0xFFFFFFFF), asm.NOP]
    return asm.Program.new(insns + after + asm.halt_sequence(0))


def _commit_words(asm, base_reg) -> list:
    """COMMIT the eight words at base_reg as the committed digest."""
    O = asm.O
    insns = []
    for j in range(8):
        insns += [asm.ri(O.LW, 5, base_reg, 4 * j), asm.imm(O.ADD, 2, 0, 0x10),
                  asm.imm(O.ADD, 4, 0, j), asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]
    return insns


SHA256_IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
             0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def sha256_chain_program(asm, n: int):
    """n rounds of SHA-256 over the previous 32-byte digest, from 32 zero
    bytes, through SHA_EXTEND and SHA_COMPRESS: the message schedule at
    0x2000 (its padding words 8..15 stored once), the state at 0x3000, set to
    the IV each round after its digest is copied into the message. Returns
    (program, the expected digest from hashlib)."""
    assert 0 < n < 0x8000
    O = asm.O
    pad = [0x80000000, 0, 0, 0, 0, 0, 0, 256]  # one 32-byte message: w[8..15]
    before = [asm.imm(O.ADD, 8, 0, 0x2000), asm.imm(O.ADD, 10, 0, 0x3000),
              *_store_words(asm, 8, 32, pad)]
    body = []
    for j in range(8):  # the last digest is the message
        body += [asm.ri(O.LW, 9, 10, 4 * j), asm.ri(O.SW, 9, 8, 4 * j)]
    body += _store_words(asm, 10, 0, SHA256_IV)
    body += [asm.imm(O.SLL, 2, 0x3001, 16), asm.ri(O.OR, 2, 2, 0x05),  # SHA_EXTEND
             asm.imm(O.ADD, 4, 0, 0x2000), asm.Instruction(O.SYSCALL, 2, 4, 5, False, False),
             asm.imm(O.SLL, 2, 0x0101, 16), asm.ri(O.OR, 2, 2, 0x06),  # SHA_COMPRESS
             asm.imm(O.ADD, 4, 0, 0x2000), asm.imm(O.ADD, 5, 0, 0x3000),
             asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]
    digest = bytes(32)
    for _ in range(n):
        digest = hashlib.sha256(digest).digest()
    return _loop(asm, n, body, before, _commit_words(asm, 10)), digest


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (the original padding, 0x01 .. 0x80) on keccakf."""
    rate = 136
    padded = bytearray(data) + bytes(rate - len(data) % rate)
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    state = [0] * 25
    for off in range(0, len(padded), rate):
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(padded[off + 8 * i : off + 8 * i + 8], "little")
        state = keccakf(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


def keccak_chain_program(asm, n: int):
    """n rounds of keccak256 over the previous 32-byte digest, from 32 zero
    bytes, one KECCAK_SPONGE call of one block a round: the block at 0x2000
    (36 words, its padding stored once, as keccak_program pads), the digest
    at 0x4000 and the length word at 0x4040. Returns (program, the expected
    digest from executor/keccak.py)."""
    assert 0 < n < 0x8000
    O = asm.O
    before = [asm.imm(O.ADD, 8, 0, 0x2000), asm.imm(O.ADD, 10, 0, 0x4000),
              asm.imm(O.ADD, 9, 0, 1), asm.ri(O.SW, 9, 8, 4 * 8),  # byte 32: 0x01
              asm.imm(O.SLL, 9, 0x8000, 16), asm.ri(O.SW, 9, 8, 4 * 33),  # byte 135: 0x80
              asm.imm(O.ADD, 9, 0, 36), asm.ri(O.SW, 9, 10, 0x40)]  # 36 words
    body = []
    for j in range(8):
        body += [asm.ri(O.LW, 9, 10, 4 * j), asm.ri(O.SW, 9, 8, 4 * j)]
    body += [asm.imm(O.SLL, 2, 0x0101, 16), asm.ri(O.OR, 2, 2, 0x09),  # KECCAK_SPONGE
             asm.imm(O.ADD, 4, 0, 0x2000), asm.imm(O.ADD, 5, 0, 0x4000),
             asm.Instruction(O.SYSCALL, 2, 4, 5, False, False)]
    digest = bytes(32)
    for _ in range(n):
        digest = keccak256(digest)
    return _loop(asm, n, body, before, _commit_words(asm, 10)), digest


def committed_digest(public_values, byteorder: str) -> bytes:
    """The 32 bytes of the eight committed words in a shard's public values
    (their first 32 felts, each word as four little-endian byte felts):
    byteorder "big" for SHA-256's state words, "little" for Keccak's lanes."""
    words = [sum(int(public_values[4 * j + i]) << (8 * i) for i in range(4)) for j in range(8)]
    return b"".join(w.to_bytes(4, byteorder) for w in words)
