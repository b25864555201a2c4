"""MIPS instruction representation
(reference: crates/core/executor/src/instruction.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from .opcode import Opcode


@dataclass(frozen=True)
class Instruction:
    opcode: Opcode
    op_a: int  # register index (destination / rs for branch)
    op_b: int  # register index or immediate
    op_c: int  # register index or immediate
    imm_b: bool = False
    imm_c: bool = False
    raw: int | None = None

    def __repr__(self):
        return (
            f"{self.opcode.name} a={self.op_a} b={self.op_b}"
            f"{'i' if self.imm_b else ''} c={self.op_c}{'i' if self.imm_c else ''}"
        )
