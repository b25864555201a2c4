from .executor import ExecutionError, Executor
from .instruction import Instruction
from .opcode import ByteOpcode, Opcode, SyscallCode
from .program import Program, decode, load_elf
from .record import ExecutionRecord, PublicValues

__all__ = [
    "ExecutionError",
    "Executor",
    "Instruction",
    "ByteOpcode",
    "Opcode",
    "SyscallCode",
    "Program",
    "decode",
    "load_elf",
    "ExecutionRecord",
    "PublicValues",
]
