"""Program container, MIPS32r2 decoder, and 32-bit LE ELF loader.

(reference: crates/core/executor/src/program.rs:52-160,
 instruction.rs:312-604 decode table, register.rs.)

Registers occupy low "addresses" 0..35 of the unified memory-checking address
space (LO=32, HI=33, BRK=34, HEAP=35), matching the reference, which stores
$brk/$heap/$sp into the image at those addresses. Guest data/code lives at
>= 0x1000, so the spaces never collide.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .instruction import Instruction
from .opcode import Opcode

MAX_CODE_MEMORY = 0x30000000
INIT_SP = 0x7FFFD000
WORD_SIZE = 4

# register indices
REG_ZERO, REG_V0, REG_A0, REG_A1 = 0, 2, 4, 5
REG_SP, REG_RA = 29, 31
REG_LO, REG_HI, REG_BRK, REG_HEAP = 32, 33, 34, 35
NUM_REGISTERS = 36


def sign_extend(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    if v & (1 << (bits - 1)):
        v |= 0xFFFFFFFF << bits
    return v & 0xFFFFFFFF


@dataclass
class Program:
    instructions: list
    pc_start: int
    pc_base: int
    image: dict = field(default_factory=dict)

    @staticmethod
    def new(instructions, pc_start=0, pc_base=0) -> "Program":
        return Program(list(instructions), pc_start, pc_base, {})

    def instruction_at(self, pc: int):
        idx = (pc - self.pc_base) // 4
        if 0 <= idx < len(self.instructions):
            return self.instructions[idx]
        return None

    @staticmethod
    def from_elf(elf: bytes) -> "Program":
        return load_elf(elf)


def decode(insn: int) -> Instruction:
    """Raw word -> semantic Instruction (reference decode table)."""
    op = (insn >> 26) & 0x3F
    func = insn & 0x3F
    rt = (insn >> 16) & 0x1F
    rs = (insn >> 21) & 0x1F
    rd = (insn >> 11) & 0x1F
    sa = (insn >> 6) & 0x1F
    imm = insn & 0xFFFF
    imm_se = sign_extend(imm, 16)
    target = insn & 0x3FFFFFF
    I = Instruction
    O = Opcode

    if op == 0b000000:
        table = {
            0b001010: I(O.MEQ, rd, rs, rt),
            0b001011: I(O.MNE, rd, rs, rt),
            0b100000: I(O.ADD, rd, rs, rt),
            0b100001: I(O.ADD, rd, rs, rt),
            0b100010: I(O.SUB, rd, rs, rt),
            0b100011: I(O.SUB, rd, rs, rt),
            0b000000: I(O.SLL, rd, rt, sa, False, True),
            0b000011: I(O.SRA, rd, rt, sa, False, True),
            0b000100: I(O.SLL, rd, rt, rs),
            0b000111: I(O.SRA, rd, rt, rs),
            0b011000: I(O.MULT, 32, rt, rs),
            0b011001: I(O.MULTU, 32, rt, rs),
            0b010000: I(O.ADD, rd, 33, 0, False, True),  # MFHI
            0b010001: I(O.ADD, 33, rs, 0, False, True),  # MTHI
            0b010010: I(O.ADD, rd, 32, 0, False, True),  # MFLO
            0b010011: I(O.ADD, 32, rs, 0, False, True),  # MTLO
            0b001111: I(O.ADD, 0, 0, 0, True, True),  # SYNC
            0x08: I(O.Jump, 0, rs, 0, False, True),  # JR
            0x09: I(O.Jump, rd, rs, 0, False, True),  # JALR
            0b101010: I(O.SLT, rd, rs, rt),
            0b101011: I(O.SLTU, rd, rs, rt),
            0b100100: I(O.AND, rd, rs, rt),
            0b100101: I(O.OR, rd, rs, rt),
            0b100110: I(O.XOR, rd, rs, rt),
            0b100111: I(O.NOR, rd, rs, rt),
            0b001100: I(O.SYSCALL, 2, 4, 5),
            0b110100: I(O.TEQ, rs, rt, 0, False, True),
        }
        if func == 0b000010:
            return I(O.ROR if rs == 1 else O.SRL, rd, rt, sa, False, True)
        if func == 0b000110:
            return I(O.ROR if sa == 1 else O.SRL, rd, rt, rs)
        if func == 0b011010:
            return I(O.MOD, rd, rs, rt) if sa == 3 else I(O.DIV, 32, rs, rt)
        if func == 0b011011:
            return I(O.MODU, rd, rs, rt) if sa == 3 else I(O.DIVU, 32, rs, rt)
        if func in table:
            return table[func]
        return I(O.UNIMPL, 0, 0, insn, True, True, raw=insn)
    if op == 0b011100:
        table = {
            0b000010: I(O.MUL, rd, rt, rs),
            0b100000: I(O.CLZ, rd, rs, 0, False, True),
            0b100001: I(O.CLO, rd, rs, 0, False, True),
            0b000001: I(O.MADDU, 32, rt, rs),
            0b000101: I(O.MSUBU, 32, rt, rs),
            0b000000: I(O.MADD, 32, rt, rs),
            0b000100: I(O.MSUB, 32, rt, rs),
        }
        if func in table:
            return table[func]
        return I(O.UNIMPL, 0, 0, insn, True, True, raw=insn)
    if op == 0x01:
        br = (imm_se << 2) & 0xFFFFFFFF
        if rt == 1:
            return I(O.BGEZ, rs, 0, br, True, True)
        if rt == 0:
            return I(O.BLTZ, rs, 0, br, True, True)
        if rt == 0x11 and rs == 0:
            return I(O.JumpDirect, 31, br, 0, True, True)
        if rt == 0x1F:
            return I(O.ADD, 0, 0, 0, True, True)  # SYNCI
        return I(O.UNIMPL, 0, 0, insn, True, True, raw=insn)
    if op == 0b011111:
        if func == 0b100000:
            if sa == 0b010000:
                return I(O.SEXT, rd, rt, 0, False, True)  # SEB
            if sa == 0b011000:
                return I(O.SEXT, rd, rt, 1, False, True)  # SEH
            if sa == 0b000010:
                return I(O.WSBH, rd, rt, 0, False, True)
            return I(O.UNIMPL, 0, 0, insn, True, True, raw=insn)
        if func == 0b000000:
            return I(O.EXT, rt, rs, (rd << 5) | sa, False, True)
        if func == 0b000100:
            return I(O.INS, rt, rs, (rd << 5) | sa, False, True)
        return I(O.UNIMPL, 0, 0, insn, True, True, raw=insn)

    br = (imm_se << 2) & 0xFFFFFFFF
    table = {
        0x02: I(Opcode.Jumpi, 0, (target << 2) & 0xFFFFFFFF, 0, True, True),
        0x03: I(Opcode.Jumpi, 31, (target << 2) & 0xFFFFFFFF, 0, True, True),
        0x04: I(Opcode.BEQ, rs, rt, br, False, True),
        0x05: I(Opcode.BNE, rs, rt, br, False, True),
        0x06: I(Opcode.BLEZ, rs, 0, br, True, True),
        0x07: I(Opcode.BGTZ, rs, 0, br, True, True),
        0b100000: I(Opcode.LB, rt, rs, imm_se, False, True),
        0b100001: I(Opcode.LH, rt, rs, imm_se, False, True),
        0b100010: I(Opcode.LWL, rt, rs, imm_se, False, True),
        0b100011: I(Opcode.LW, rt, rs, imm_se, False, True),
        0b100100: I(Opcode.LBU, rt, rs, imm_se, False, True),
        0b100101: I(Opcode.LHU, rt, rs, imm_se, False, True),
        0b100110: I(Opcode.LWR, rt, rs, imm_se, False, True),
        0b110000: I(Opcode.LL, rt, rs, imm_se, False, True),
        0b101000: I(Opcode.SB, rt, rs, imm_se, False, True),
        0b101001: I(Opcode.SH, rt, rs, imm_se, False, True),
        0b101010: I(Opcode.SWL, rt, rs, imm_se, False, True),
        0b101011: I(Opcode.SW, rt, rs, imm_se, False, True),
        0b101110: I(Opcode.SWR, rt, rs, imm_se, False, True),
        0b111000: I(Opcode.SC, rt, rs, imm_se, False, True),
        0b001000: I(Opcode.ADD, rt, rs, imm_se, False, True),
        0b001001: I(Opcode.ADD, rt, rs, imm_se, False, True),
        0b001010: I(Opcode.SLT, rt, rs, imm_se, False, True),
        0b001011: I(Opcode.SLTU, rt, rs, imm_se, False, True),
        0b001111: I(Opcode.SLL, rt, imm_se, 16, True, True),  # LUI
        0b001100: I(Opcode.AND, rt, rs, imm, False, True),
        0b001101: I(Opcode.OR, rt, rs, imm, False, True),
        0b001110: I(Opcode.XOR, rt, rs, imm, False, True),
        0b110011: I(Opcode.ADD, 0, 0, 0, True, True),  # PREF
    }
    if op in table:
        return table[op]
    return I(Opcode.UNIMPL, 0, 0, insn, True, True, raw=insn)


def load_elf(data: bytes) -> Program:
    """Minimal 32-bit LE MIPS ET_EXEC loader (reference program.rs:52-160).

    The reference additionally NOPs out a list of Go-runtime symbols
    (patch_elf); that is applied here only when a symbol table is present.
    """
    assert data[:4] == b"\x7fELF", "not an ELF"
    ei_class, ei_data = data[4], data[5]
    assert ei_class == 1, "must be ELF32"
    assert ei_data == 1, "must be little-endian"
    e_type, e_machine = struct.unpack_from("<HH", data, 16)
    assert e_type == 2, "must be ET_EXEC"
    assert e_machine == 8, "must be EM_MIPS"
    (e_entry,) = struct.unpack_from("<I", data, 24)
    (e_phoff,) = struct.unpack_from("<I", data, 28)
    (e_phentsize,) = struct.unpack_from("<H", data, 42)
    (e_phnum,) = struct.unpack_from("<H", data, 44)

    image: dict[int, int] = {}
    instructions_raw: list[int] = []
    base_address = 0xFFFFFFFF
    hiaddr = 0

    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        p_type, p_offset, p_vaddr, _p_paddr, p_filesz, p_memsz, p_flags, _al = (
            struct.unpack_from("<IIIIIIII", data, off)
        )
        if p_type != 1:  # PT_LOAD
            continue
        assert p_vaddr % 4 == 0, "unaligned segment vaddr"
        executable = (p_flags & 1) != 0  # PF_X
        if executable and p_vaddr < base_address:
            base_address = p_vaddr
        for j in range(0, p_memsz, WORD_SIZE):
            addr = p_vaddr + j
            assert addr < MAX_CODE_MEMORY, "address exceeds guest max"
            if j >= p_filesz:
                image[addr] = 0
            else:
                nbytes = min(p_filesz - j, 4)
                word = int.from_bytes(
                    data[p_offset + j : p_offset + j + nbytes], "little"
                )
                image[addr] = word
                if executable:
                    instructions_raw.append(word)
            hiaddr = max(hiaddr, addr)

    image[REG_BRK] = hiaddr
    image[REG_HEAP] = 0x20000000
    _patch_stack(image)

    instructions = [decode(w) for w in instructions_raw]
    return Program(instructions, e_entry, base_address, image)


def _patch_stack(image: dict) -> None:
    sp = INIT_SP
    image[REG_SP] = sp
    image[sp] = 0  # argc
    image[sp + 4] = 0  # argv terminator
    image[sp + 8] = 0  # envp terminator
    aux = [(6, 0x1000), (11, 0x3E8), (12, 0x3E8), (13, 0x3E8), (14, 0x3E8), (0, 0)]
    cur = sp + 12
    for k, v in aux:
        image[cur] = k
        image[cur + 4] = v
        cur += 8
