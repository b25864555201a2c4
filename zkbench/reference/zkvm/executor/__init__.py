"""Instruction, opcode, program and record types of the executor; the
executor itself is not part of the reference."""
