"""MIPS32r2 semantic opcodes (reference: crates/core/executor/src/opcode.rs:26-90).

Values match the reference exactly so traces/events stay comparable."""

from __future__ import annotations

from enum import IntEnum


class Opcode(IntEnum):
    # ALU
    ADD = 0
    SUB = 1
    MUL = 2
    MULT = 3
    MULTU = 4
    DIV = 5
    DIVU = 6
    MOD = 7
    MODU = 8
    SLL = 9
    SRL = 10
    SRA = 11
    ROR = 12
    SLT = 13
    SLTU = 14
    AND = 15
    OR = 16
    XOR = 17
    NOR = 18
    CLZ = 19
    CLO = 20
    # Control flow
    BEQ = 21
    BGEZ = 22
    BGTZ = 23
    BLEZ = 24
    BLTZ = 25
    BNE = 26
    Jump = 27
    Jumpi = 28
    JumpDirect = 29
    SYSCALL = 30
    # Memory
    LB = 31
    LBU = 32
    LH = 33
    LHU = 34
    LW = 35
    LWL = 36
    LWR = 37
    LL = 38
    SB = 39
    SH = 40
    SW = 41
    SWL = 42
    SWR = 43
    SC = 44
    # Misc
    INS = 45
    MADDU = 46
    MSUBU = 47
    MADD = 48
    MSUB = 49
    MEQ = 50
    MNE = 51
    WSBH = 52
    EXT = 53
    TEQ = 54
    SEXT = 55
    UNIMPL = 0xFF


ALU_OPCODES = frozenset(
    {
        Opcode.ADD, Opcode.SUB, Opcode.MUL, Opcode.MULT, Opcode.MULTU,
        Opcode.DIV, Opcode.DIVU, Opcode.MOD, Opcode.MODU, Opcode.SLL,
        Opcode.SRL, Opcode.SRA, Opcode.ROR, Opcode.SLT, Opcode.SLTU,
        Opcode.AND, Opcode.OR, Opcode.XOR, Opcode.NOR, Opcode.CLZ, Opcode.CLO,
    }
)
BRANCH_OPCODES = frozenset(
    {Opcode.BEQ, Opcode.BGEZ, Opcode.BGTZ, Opcode.BLEZ, Opcode.BLTZ, Opcode.BNE}
)
JUMP_OPCODES = frozenset({Opcode.Jump, Opcode.Jumpi, Opcode.JumpDirect})
LOAD_OPCODES = frozenset(
    {Opcode.LB, Opcode.LBU, Opcode.LH, Opcode.LHU, Opcode.LW, Opcode.LWL, Opcode.LWR, Opcode.LL}
)
STORE_OPCODES = frozenset(
    {Opcode.SB, Opcode.SH, Opcode.SW, Opcode.SWL, Opcode.SWR, Opcode.SC}
)
MEM_OPCODES = LOAD_OPCODES | STORE_OPCODES
MISC_OPCODES = frozenset(
    {
        Opcode.INS, Opcode.MADDU, Opcode.MSUBU, Opcode.MADD, Opcode.MSUB,
        Opcode.MEQ, Opcode.MNE, Opcode.WSBH, Opcode.EXT, Opcode.TEQ, Opcode.SEXT,
    }
)


class ByteOpcode(IntEnum):
    """(reference: crates/core/executor/src/opcode.rs:195-216)"""

    AND = 0
    OR = 1
    XOR = 2
    SLL = 3
    U8Range = 4
    ShrCarry = 5
    LTU = 6
    MSB = 7
    U16Range = 8
    NOR = 9
    # extension beyond the reference's 10 ops: per-byte count-leading-zeros
    # (used by CloClzChip; the reference uses bit decomposition instead)
    CLZ8 = 10


class SyscallCode(IntEnum):
    """(reference: crates/core/executor/src/syscalls/code.rs:28-189, subset)"""

    HALT = 0x00_00_00_00
    WRITE = 0x00_00_00_02
    ENTER_UNCONSTRAINED = 0x00_00_00_03
    EXIT_UNCONSTRAINED = 0x00_00_00_04
    SHA_EXTEND = 0x30_01_00_05
    SHA_COMPRESS = 0x01_01_00_06
    KECCAK_SPONGE = 0x01_01_00_09
    ED_ADD = 0x01_01_00_07
    ED_DECOMPRESS = 0x00_01_00_08
    SECP256K1_ADD = 0x01_01_00_0A
    SECP256K1_DOUBLE = 0x00_01_00_0B
    SECP256K1_DECOMPRESS = 0x00_01_00_0C
    BLS12381_DECOMPRESS = 0x00_01_00_1C
    SECP256R1_DECOMPRESS = 0x00_01_00_2E
    BN254_ADD = 0x01_01_00_0E
    BN254_DOUBLE = 0x00_01_00_0F
    BLS12381_ADD = 0x01_01_00_1E
    BLS12381_DOUBLE = 0x00_01_00_1F
    BLS12381_FP_ADD = 0x01_01_00_20
    BLS12381_FP_SUB = 0x01_01_00_21
    BLS12381_FP_MUL = 0x01_01_00_22
    BLS12381_FP2_ADD = 0x01_01_00_23
    BLS12381_FP2_SUB = 0x01_01_00_24
    BLS12381_FP2_MUL = 0x01_01_00_25
    BN254_FP_ADD = 0x01_01_00_26
    BN254_FP_SUB = 0x01_01_00_27
    BN254_FP_MUL = 0x01_01_00_28
    BN254_FP2_ADD = 0x01_01_00_29
    BN254_FP2_SUB = 0x01_01_00_2A
    BN254_FP2_MUL = 0x01_01_00_2B
    SECP256R1_ADD = 0x01_01_00_2C
    SECP256R1_DOUBLE = 0x00_01_00_2D
    U256XU2048_MUL = 0x01_01_00_2F
    COMMIT = 0x00_00_00_10
    COMMIT_DEFERRED_PROOFS = 0x00_00_00_1A
    VERIFY_ZKM_PROOF = 0x00_00_00_1B
    UINT256_MUL = 0x01_01_00_1D
    POSEIDON2_PERMUTE = 0x00_01_00_30
    BOOLEAN_CIRCUIT_GARBLE = 0x00_01_00_31
    # Linux O32 ABI syscalls (reference code.rs:140-190; executor-level
    # emulation — the SysLinux chip lands with the Linux-ABI milestone)
    SYS_LINUX = 4000
    SYS_READ = 4003
    SYS_WRITE = 4004
    SYS_BRK = 4045
    SYS_FCNTL = 4055
    SYS_MMAP2 = 4090
    SYS_MMAP = 4210
    SYS_CLONE = 4120
    SYS_EXT_GROUP = 4246
    SYSHINTLEN = 0x00_00_00_F0
    SYSHINTREAD = 0x00_00_00_F1
    SYSVERIFY = 0x00_00_00_F2
