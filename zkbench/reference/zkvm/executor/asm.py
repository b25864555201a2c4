"""Tiny raw-instruction program builders for tests and benchmarks
(the reference builds per-chip test programs the same way:
crates/core/executor/src/programs.rs simple_program)."""

from __future__ import annotations

from .instruction import Instruction
from .opcode import Opcode
from .program import Program

O = Opcode


def imm(op, a, b, c):
    return Instruction(op, a, b & 0xFFFFFFFF, c & 0xFFFFFFFF, True, True)


def ri(op, a, b, c):
    """register b, immediate c"""
    return Instruction(op, a, b, c & 0xFFFFFFFF, False, True)


def rr(op, a, b, c):
    return Instruction(op, a, b, c, False, False)


NOP = Instruction(O.ADD, 0, 0, 0, True, True)


def halt_sequence(code=0):
    """v0 = HALT(0); a0 = exit code; syscall."""
    return [
        imm(O.ADD, 2, 0, 0),  # v0 = 0 (HALT)
        imm(O.ADD, 4, 0, code),  # a0 = code
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
    ]


def simple_program() -> Program:
    """reference programs.rs:15 — r31 = 5 + 37."""
    return Program.new(
        [
            imm(O.ADD, 29, 0, 5),
            imm(O.ADD, 30, 0, 37),
            rr(O.ADD, 31, 30, 29),
        ]
    )


def fibonacci_program(n: int) -> Program:
    """Iterative fibonacci in registers; result in r10; commits r10.

    Exercises ALU, branch with delay slot, SYSCALL(COMMIT/HALT).
    """
    insns = [
        imm(O.ADD, 8, 0, n),  # t0 = n
        imm(O.ADD, 9, 0, 0),  # t1 = a = 0
        imm(O.ADD, 10, 0, 1),  # t2 = b = 1
        # loop: (pc = 12)
        rr(O.ADD, 11, 9, 10),  # t3 = a + b
        ri(O.ADD, 9, 10, 0),  # a = b
        ri(O.ADD, 10, 11, 0),  # b = t3
        ri(O.SUB, 8, 8, 1),  # n -= 1
        ri(O.BGTZ, 8, 0, (12 - (16 + 4)) & 0xFFFFFFFF),  # loop if n > 0
        NOP,  # delay slot
        # commit word 0 = b: v0=COMMIT(0x10), a0=0, a1=b
        imm(O.ADD, 2, 0, 0x10),
        imm(O.ADD, 4, 0, 0),
        ri(O.ADD, 5, 10, 0),
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        *halt_sequence(0),
    ]
    # fix branch: BGTZ at index 7 -> pc = 28, next_pc = 32, target = 12
    insns[7] = ri(O.BGTZ, 8, 0, (12 - 32) & 0xFFFFFFFF)
    return Program.new(insns)


def memory_program() -> Program:
    """Store/load word + bytes at 0x2000; result r20 = 0x12345678, r21 = 0x78."""
    return Program.new(
        [
            imm(O.ADD, 8, 0, 0x2000),  # t0 = base
            imm(O.SLL, 9, 0x1234, 16),  # t1 = 0x12340000
            imm(O.ADD, 10, 0, 0x5678),
            rr(O.OR, 9, 9, 10),  # t1 = 0x12345678
            ri(O.SW, 9, 8, 0),  # [base] = t1
            ri(O.LW, 20, 8, 0),  # r20 = [base]
            ri(O.LBU, 21, 8, 0),  # r21 = low byte
            ri(O.SB, 10, 8, 4),  # [base+4].b0 = 0x78
            ri(O.LW, 22, 8, 4),  # r22 = 0x78
            *halt_sequence(0),
        ]
    )


def alu_torture_program() -> Program:
    """Exercises MUL/MULT/MULTU/CLZ/CLO/SEXT/WSBH/MOVZ/MOVN/SLT and shifts."""
    return Program.new(
        [
            imm(O.ADD, 8, 0, 0x1234),
            imm(O.SLL, 8, 0x1234, 16),  # t0 = 0x12340000 (LUI)
            ri(O.OR, 8, 8, 0x5678),  # t0 = 0x12345678 (ORI)
            imm(O.ADD, 9, 0, 0xFFFF),
            ri(O.SLL, 9, 9, 16),
            ri(O.SRA, 10, 9, 4),  # sign-propagating shift
            ri(O.ROR, 11, 8, 8),
            rr(O.MUL, 12, 8, 9),  # low product
            rr(O.MULT, 32, 8, 9),  # (hi, lo) signed
            imm(O.ADD, 13, 0, 0),
            rr(O.ADD, 13, 13, 33),  # t5 = HI (MFHI)
            rr(O.MULTU, 32, 8, 9),  # (hi, lo) unsigned
            rr(O.ADD, 14, 0, 33),  # MFHI
            ri(O.CLZ, 15, 8, 0),
            ri(O.CLO, 16, 9, 0),
            ri(O.SEXT, 17, 8, 0),  # SEB
            ri(O.SEXT, 18, 8, 1),  # SEH
            ri(O.WSBH, 19, 8, 0),
            rr(O.MEQ, 20, 8, 0),  # MOVZ: r20 = r8 if r0 == 0 (true)
            rr(O.MNE, 21, 8, 9),  # MOVN: r21 = r8 if r9 != 0 (true)
            rr(O.SLT, 22, 9, 8),  # signed: r9 < r8 (r9 negative)
            rr(O.SLTU, 23, 9, 8),  # unsigned: r9 > r8 -> 0
            *halt_sequence(0),
        ]
    )


def alu_torture2_program() -> Program:
    """DIV/DIVU/MOD/MODU/MADD/MSUB/MADDU/MSUBU/EXT/INS/TEQ."""
    return Program.new(
        [
            imm(O.ADD, 8, 0, 1000),
            imm(O.ADD, 9, 0, 7),
            imm(O.SUB, 10, 0, 1000),  # -1000
            rr(O.DIV, 32, 10, 9),  # lo = -142, hi = -6
            rr(O.ADD, 11, 0, 32),  # MFLO
            rr(O.ADD, 12, 0, 33),  # MFHI
            rr(O.DIVU, 32, 8, 9),  # 142, 6
            rr(O.ADD, 13, 0, 32),
            rr(O.MOD, 14, 10, 9),  # -6
            rr(O.MODU, 15, 8, 9),  # 6
            # MADD/MSUB accumulate into (HI, LO)
            rr(O.MULT, 32, 8, 9),  # acc = 7000
            rr(O.MADD, 32, 8, 9),  # acc = 14000
            rr(O.MSUB, 32, 9, 9),  # acc = 13951
            rr(O.MADDU, 32, 8, 8),  # acc += 1000000
            rr(O.ADD, 16, 0, 32),
            # EXT/INS
            imm(O.SLL, 17, 0x1234, 16),
            ri(O.OR, 17, 17, 0x5678),  # r17 = 0x12345678
            ri(O.EXT, 18, 17, (7 << 5) | 8),  # extract bits 8..15 -> 0x56
            ri(O.ADD, 19, 17, 0),
            ri(O.INS, 19, 9, (15 << 5) | 8),  # insert r9 low 8.. bits 8..15
            # TEQ (not equal -> no trap)
            ri(O.TEQ, 8, 9, 0),
            *halt_sequence(0),
        ]
    )


def poseidon2_program() -> Program:
    """Calls the poseidon2 permute precompile on a state at 0x2000."""
    return Program.new(
        [
            imm(O.ADD, 8, 0, 0x2000),
            imm(O.ADD, 9, 0, 7),
            ri(O.SW, 9, 8, 0),  # state[0] = 7
            ri(O.SW, 9, 8, 60),  # state[15] = 7
            imm(O.SLL, 2, 1, 16),  # v0 = 0x00010000
            ri(O.OR, 2, 2, 0x30),  # v0 = POSEIDON2_PERMUTE
            imm(O.ADD, 4, 0, 0x2000),  # a0 = ptr
            Instruction(O.SYSCALL, 2, 4, 5, False, False),
            imm(O.ADD, 8, 0, 0x2000),
            ri(O.LW, 20, 8, 0),  # r20 = out[0]
            ri(O.LW, 21, 8, 4),  # r21 = out[1]
            *halt_sequence(0),
        ]
    )


def sha_extend_program() -> Program:
    """Fills w[0..16] at 0x2000 and runs the sha_extend precompile."""
    insns = [imm(O.ADD, 8, 0, 0x2000)]
    for i in range(16):
        insns += [imm(O.ADD, 9, 0, i * 0x1111 + 1), ri(O.SW, 9, 8, 4 * i)]
    insns += [
        imm(O.SLL, 2, 0x3001, 16),  # v0 = 0x30010000
        ri(O.OR, 2, 2, 0x05),  # v0 = SHA_EXTEND
        imm(O.ADD, 4, 0, 0x2000),  # a0 = ptr
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ri(O.LW, 20, 8, 4 * 63),  # r20 = w[63]
        ri(O.LW, 21, 8, 4 * 16),  # r21 = w[16]
        *halt_sequence(0),
    ]
    return Program.new(insns)


def sha256_program() -> Program:
    """Full SHA-256 of the empty message via extend + compress precompiles."""
    IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
    insns = [imm(O.ADD, 8, 0, 0x2000), imm(O.ADD, 10, 0, 0x3000)]
    for j, v in enumerate(IV):
        insns += [imm(O.SLL, 9, v >> 16, 16), ri(O.OR, 9, 9, v & 0xFFFF),
                  ri(O.SW, 9, 10, 4 * j)]
    insns += [imm(O.SLL, 9, 0x8000, 16), ri(O.SW, 9, 8, 0)]  # padded block
    insns += [
        imm(O.SLL, 2, 0x3001, 16), ri(O.OR, 2, 2, 0x05),  # SHA_EXTEND
        imm(O.ADD, 4, 0, 0x2000),
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        imm(O.SLL, 2, 0x0101, 16), ri(O.OR, 2, 2, 0x06),  # SHA_COMPRESS
        imm(O.ADD, 4, 0, 0x2000), imm(O.ADD, 5, 0, 0x3000),
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ri(O.LW, 20, 10, 0),
        *halt_sequence(0),
    ]
    return Program.new(insns)


def uint256_program(x: int, y: int, m: int) -> Program:
    """x * y mod m (m == 0 means 2^256) via the UINT256_MUL precompile:
    x at 0x2000 (result written back there), y at 0x2100, m at 0x2120."""

    def store_words(base_reg_insns, base, value):
        insns = list(base_reg_insns)
        for i in range(8):
            w = (value >> (32 * i)) & 0xFFFFFFFF
            insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                      ri(O.SW, 9, 8, base + 4 * i)]
        return insns

    insns = [imm(O.ADD, 8, 0, 0x2000)]
    insns = store_words(insns, 0x000, x)
    insns = store_words(insns, 0x100, y)
    insns = store_words(insns, 0x120, m)
    insns += [
        imm(O.SLL, 2, 0x0101, 16), ri(O.OR, 2, 2, 0x1D),  # UINT256_MUL
        imm(O.ADD, 4, 0, 0x2000),  # a0 = x_ptr
        imm(O.ADD, 5, 0, 0x2100),  # a1 = y_ptr
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ri(O.LW, 20, 8, 0),  # r20 = result word 0
        ri(O.LW, 21, 8, 28),  # r21 = result word 7
        *halt_sequence(0),
    ]
    return Program.new(insns)


def keccak_program(data: bytes) -> Program:
    """keccak256(data) via the KECCAK_SPONGE precompile. The caller-side
    padding (0x01 .. 0x80 over a 136-byte rate block) is applied here and the
    padded block is extended to the sponge's 144-byte general block with zero
    capacity-lane words, matching how the reference guest drives the syscall.
    Input at 0x2000, result at 0x4000 (length word at 0x4040)."""
    rate = 136
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] = 0x01
    padded[-1] |= 0x80
    # widen each 136-byte rate block to a 144-byte general block
    blocks = b"".join(
        bytes(padded[i : i + rate]) + b"\x00" * 8
        for i in range(0, len(padded), rate)
    )
    words = [int.from_bytes(blocks[4 * i : 4 * i + 4], "little")
             for i in range(len(blocks) // 4)]
    insns = [imm(O.ADD, 8, 0, 0x2000), imm(O.ADD, 10, 0, 0x4000)]
    for i, v in enumerate(words):
        insns += [imm(O.SLL, 9, v >> 16, 16), ri(O.OR, 9, 9, v & 0xFFFF),
                  ri(O.SW, 9, 8, 4 * i)]
    insns += [imm(O.ADD, 9, 0, len(words)), ri(O.SW, 9, 10, 0x40)]
    insns += [
        imm(O.SLL, 2, 0x0101, 16), ri(O.OR, 2, 2, 0x09),  # KECCAK_SPONGE
        imm(O.ADD, 4, 0, 0x2000),  # a0 = input_ptr
        imm(O.ADD, 5, 0, 0x4000),  # a1 = result_ptr
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ri(O.LW, 20, 10, 0),  # r20 = digest word 0
        ri(O.LW, 21, 10, 28),  # r21 = digest word 7
        *halt_sequence(0),
    ]
    return Program.new(insns)


def secp256k1_program(op: str = "add") -> Program:
    """Computes G + 2G (op='add') or 2G (op='double') on secp256k1 via the
    weierstrass precompiles. Points at 0x2000 (p, overwritten) / 0x2200 (q)."""
    GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
    GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
    # 2G (well-known)
    G2X = 0xC6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5
    G2Y = 0x1AE168FEA63DC339A3C58419466CEAEEF7F632653266D0E1236431A950CFE52A

    def store_point(insns, base, x, y):
        v = x | (y << 256)
        for i in range(16):
            w = (v >> (32 * i)) & 0xFFFFFFFF
            insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                      ri(O.SW, 9, 8, base + 4 * i)]
        return insns

    insns = [imm(O.ADD, 8, 0, 0x2000)]
    if op == "add":
        insns = store_point(insns, 0x000, GX, GY)
        insns = store_point(insns, 0x200, G2X, G2Y)
        insns += [
            imm(O.SLL, 2, 0x0101, 16), ri(O.OR, 2, 2, 0x0A),  # SECP256K1_ADD
            imm(O.ADD, 4, 0, 0x2000), imm(O.ADD, 5, 0, 0x2200),
            Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ]
    else:
        insns = store_point(insns, 0x000, GX, GY)
        insns += [
            imm(O.SLL, 2, 0x0001, 16), ri(O.OR, 2, 2, 0x0B),  # SECP256K1_DOUBLE
            imm(O.ADD, 4, 0, 0x2000),
            Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ]
    insns += [
        ri(O.LW, 20, 8, 0),  # r20 = x3 word 0
        ri(O.LW, 21, 8, 32),  # r21 = y3 word 0
        *halt_sequence(0),
    ]
    return Program.new(insns)


EC_CURVES = {
    "secp256k1": (
        (1 << 256) - (1 << 32) - 977, 0, 0x0101, 0x0A, 0x0001, 0x0B,
        0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
        0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
    ),
    "secp256r1": (
        (1 << 256) - (1 << 224) + (1 << 192) + (1 << 96) - 1,
        -3, 0x0101, 0x2C, 0x0001, 0x2D,
        0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
        0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    ),
    "bn254": (
        21888242871839275222246405745257275088696311157297823662689037894645226208583,
        0, 0x0101, 0x0E, 0x0001, 0x0F, 1, 2,
    ),
    "bls12381": (
        int("1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
            "1eabfffeb153ffffb9feffffffffaaab", 16),
        0, 0x0101, 0x1E, 0x0001, 0x1F,
        int("17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
            "6c55e83ff97a1aeffb3af00adb22c6bb", 16),
        int("08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
            "d03cc744a2888ae40caa232946c5e7e1", 16),
    ),
}


def ec_reference(curve: str, op: str):
    """Host oracle: (2G, 3G) affine points for the named curve."""
    m, a, *_rest, gx, gy = EC_CURVES[curve]
    a %= m
    lam = ((3 * gx * gx + a) * pow(2 * gy, m - 2, m)) % m
    x2 = (lam * lam - 2 * gx) % m
    y2 = (lam * (gx - x2) - gy) % m
    if op == "double":
        return x2, y2
    lam = ((y2 - gy) * pow(x2 - gx, m - 2, m)) % m
    x3 = (lam * lam - gx - x2) % m
    y3 = (lam * (gx - x3) - gy) % m
    return x3, y3


def ec_program(curve: str, op: str = "add") -> Program:
    """G + 2G (op='add') or 2G (op='double') via the weierstrass precompiles.
    Points at 0x2000 (p, overwritten) / 0x2200 (q)."""
    m, a, add_hi, add_lo, dbl_hi, dbl_lo, gx, gy = EC_CURVES[curve]
    nw = 12 if curve == "bls12381" else 8  # words per coordinate
    g2x, g2y = ec_reference(curve, "double")

    def store_point(insns, base, x, y):
        v = x | (y << (32 * nw))
        for i in range(2 * nw):
            w = (v >> (32 * i)) & 0xFFFFFFFF
            insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                      ri(O.SW, 9, 8, base + 4 * i)]
        return insns

    insns = [imm(O.ADD, 8, 0, 0x2000)]
    if op == "add":
        insns = store_point(insns, 0x000, gx, gy)
        insns = store_point(insns, 0x200, g2x, g2y)
        insns += [
            imm(O.SLL, 2, add_hi, 16), ri(O.OR, 2, 2, add_lo),
            imm(O.ADD, 4, 0, 0x2000), imm(O.ADD, 5, 0, 0x2200),
            Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ]
    else:
        insns = store_point(insns, 0x000, gx, gy)
        insns += [
            imm(O.SLL, 2, dbl_hi, 16), ri(O.OR, 2, 2, dbl_lo),
            imm(O.ADD, 4, 0, 0x2000),
            Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ]
    insns += [
        ri(O.LW, 20, 8, 0),
        ri(O.LW, 21, 8, 4 * nw),
        *halt_sequence(0),
    ]
    return Program.new(insns)


WDECOMPRESS_CODES = {
    "secp256k1": (0x0001, 0x0C),
    "secp256r1": (0x0001, 0x2E),
    "bls12381": (0x0001, 0x1C),
}


def wdecompress_reference(curve: str, sign: int):
    """Host oracle: the y the decompress syscall must recover for the
    curve's generator x and the given sign bit (parity rule for secp*,
    lexicographically-largest rule for bls12-381)."""
    m, a, *_rest, gx, gy = EC_CURVES[curve]
    if curve == "bls12381":
        return max(gy, m - gy) if sign else min(gy, m - gy)
    return gy if (gy & 1) == sign else m - gy


def wdecompress_program(curve: str, sign: int = 0) -> Program:
    """Decompress the curve generator's x via the curve's DECOMPRESS
    precompile. Slice at 0x2000: y written to +0, x stored at +4*nw."""
    m, a, *_rest, gx, gy = EC_CURVES[curve]
    nw = 12 if curve == "bls12381" else 8
    hi, lo = WDECOMPRESS_CODES[curve]

    insns = [imm(O.ADD, 8, 0, 0x2000)]
    for i in range(nw):
        w = (gx >> (32 * i)) & 0xFFFFFFFF
        insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                  ri(O.SW, 9, 8, 4 * nw + 4 * i)]
    insns += [
        imm(O.SLL, 2, hi, 16), ri(O.OR, 2, 2, lo),
        imm(O.ADD, 4, 0, 0x2000), imm(O.ADD, 5, 0, sign),
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ri(O.LW, 20, 8, 0),
        *halt_sequence(0),
    ]
    return Program.new(insns)


ED25519_P = (1 << 255) - 19
ED25519_D = 37095705934669439343138083508754565189542113879843219016388785533085940283555
ED25519_GX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
ED25519_GY = 46316835694926478169428394003475163141307993866256225615783033603165251855960


def ed25519_reference(x1, y1, x2, y2):
    m, d = ED25519_P, ED25519_D
    den = (d * x1 * x2 * y1 * y2) % m
    x3 = ((x1 * y2 + x2 * y1) * pow(1 + den, m - 2, m)) % m
    y3 = ((y1 * y2 + x1 * x2) * pow(1 - den, m - 2, m)) % m
    return x3, y3


def ed25519_program(double: bool = False) -> Program:
    """G + G (complete addition law doubles too) or G + 2G via ED_ADD."""
    gx, gy = ED25519_GX, ED25519_GY
    qx, qy = (gx, gy) if double else ed25519_reference(gx, gy, gx, gy)

    def store_point(insns, base, x, y):
        v = x | (y << 256)
        for i in range(16):
            w = (v >> (32 * i)) & 0xFFFFFFFF
            insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                      ri(O.SW, 9, 8, base + 4 * i)]
        return insns

    insns = [imm(O.ADD, 8, 0, 0x2000)]
    insns = store_point(insns, 0x000, gx, gy)
    insns = store_point(insns, 0x200, qx, qy)
    insns += [
        imm(O.SLL, 2, 0x0101, 16), ri(O.OR, 2, 2, 0x07),  # ED_ADD
        imm(O.ADD, 4, 0, 0x2000), imm(O.ADD, 5, 0, 0x2200),
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ri(O.LW, 20, 8, 0),
        ri(O.LW, 21, 8, 32),
        *halt_sequence(0),
    ]
    return Program.new(insns)


def fp_op_program(code_hi: int, code_lo: int, x: int, y: int, nw: int) -> Program:
    """Generic Fp/Fp2 precompile caller: x at 0x2000 (result written back),
    y at 0x3000; nw = u32 words per element."""
    insns = [imm(O.ADD, 8, 0, 0x2000), imm(O.ADD, 10, 0, 0x3000)]
    for base_reg, base, v in ((8, 0, x), (10, 0, y)):
        for i in range(nw):
            w = (v >> (32 * i)) & 0xFFFFFFFF
            insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                      ri(O.SW, 9, base_reg, base + 4 * i)]
    insns += [
        imm(O.SLL, 2, code_hi, 16), ri(O.OR, 2, 2, code_lo),
        imm(O.ADD, 4, 0, 0x2000), imm(O.ADD, 5, 0, 0x3000),
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ri(O.LW, 20, 8, 0),
        *halt_sequence(0),
    ]
    return Program.new(insns)


def ed_decompress_program(sign: int = 0) -> Program:
    """Decompress the ed25519 base point's y (optionally with the sign bit
    flipped to select -x). Slice at 0x2000: x written to +0, y stored at +32."""
    y = ED25519_GY

    insns = [imm(O.ADD, 8, 0, 0x2000)]
    for i in range(8):
        w = (y >> (32 * i)) & 0xFFFFFFFF
        insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                  ri(O.SW, 9, 8, 32 + 4 * i)]
    insns += [
        imm(O.SLL, 2, 0x0001, 16), ri(O.OR, 2, 2, 0x08),  # ED_DECOMPRESS
        imm(O.ADD, 4, 0, 0x2000), imm(O.ADD, 5, 0, sign),
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ri(O.LW, 20, 8, 0),
        *halt_sequence(0),
    ]
    return Program.new(insns)


def u256x2048_program(a: int, b_val: int) -> Program:
    """(hi, lo) = a * b via U256XU2048_MUL. a at 0x2000, b at 0x2100,
    lo to 0x3000 (A2), hi to 0x3200 (A3)."""
    insns = [imm(O.ADD, 8, 0, 0x2000)]
    for i in range(8):
        w = (a >> (32 * i)) & 0xFFFFFFFF
        insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                  ri(O.SW, 9, 8, 0x000 + 4 * i)]
    for i in range(64):
        w = (b_val >> (32 * i)) & 0xFFFFFFFF
        insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                  ri(O.SW, 9, 8, 0x100 + 4 * i)]
    insns += [
        imm(O.SLL, 2, 0x0101, 16), ri(O.OR, 2, 2, 0x2F),  # U256XU2048_MUL
        imm(O.ADD, 4, 0, 0x2000),  # a0 = a_ptr
        imm(O.ADD, 5, 0, 0x2100),  # a1 = b_ptr
        imm(O.ADD, 6, 0, 0x3000),  # a2 = lo_ptr
        imm(O.ADD, 7, 0, 0x3200),  # a3 = hi_ptr
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
        imm(O.ADD, 10, 0, 0x3000),
        ri(O.LW, 20, 10, 0),  # lo word 0
        ri(O.LW, 21, 10, 0x200),  # hi word 0
        *halt_sequence(0),
    ]
    return Program.new(insns)


def deferred_claim_program(vkey_words, pvd_words, digest_words) -> Program:
    """Guest that defers one sub-proof claim: VERIFY_ZKM_PROOF(vkey@0x2000,
    pvd@0x2100), then COMMIT_DEFERRED_PROOFS of the folded deferred digest
    (precomputed host-side with recursion.deferred.fold_claims, matching the
    reference guest's in-VM hash_deferred_proof — primitives/src/lib.rs:1140,
    zkvm/lib/src/verify.rs)."""
    insns = [imm(O.ADD, 8, 0, 0x2000)]
    for i, w in enumerate(vkey_words):
        w = int(w)
        insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                  ri(O.SW, 9, 8, 4 * i)]
    for i, w in enumerate(pvd_words):
        w = int(w)
        insns += [imm(O.SLL, 9, w >> 16, 16), ri(O.OR, 9, 9, w & 0xFFFF),
                  ri(O.SW, 9, 8, 0x100 + 4 * i)]
    insns += [
        imm(O.ADD, 2, 0, 0x1B),  # VERIFY_ZKM_PROOF
        imm(O.ADD, 4, 0, 0x2000),  # a0 = vkey ptr
        imm(O.ADD, 5, 0, 0x2100),  # a1 = pv digest ptr
        Instruction(O.SYSCALL, 2, 4, 5, False, False),
    ]
    for i, w in enumerate(digest_words):
        w = int(w)
        insns += [
            imm(O.ADD, 2, 0, 0x1A),  # COMMIT_DEFERRED_PROOFS
            imm(O.ADD, 4, 0, i),  # word index
            imm(O.SLL, 5, w >> 16, 16), ri(O.OR, 5, 5, w & 0xFFFF),
            Instruction(O.SYSCALL, 2, 4, 5, False, False),
        ]
    insns += [*halt_sequence(0)]
    return Program.new(insns)
