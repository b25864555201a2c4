"""MIPS32r2 executor with columnar event tracing.

Semantics pinned to the reference executor
(reference: crates/core/executor/src/executor.rs):
  * branch-delay-slot pc model: (pc, next_pc, next_next_pc);
  * clk advances 5 per cycle; memory access timestamps are clk + position
    with positions Memory=0, C=1, B=2, A=3, HI=4 (events/memory.rs:29-40);
  * registers live at addresses 0..35 (LO=32, HI=33, BRK=34, HEAP=35) of the
    unified memory-checking address space;
  * first access of an address records an init event (offline memory
    checking start point); finalize events are emitted at the end.

Modes: 'simple' (no events) and 'trace' (columnar events). The sequential
hot loop is the C++ port target (SURVEY.md §2.1); this Python version is the
semantic oracle.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..core import poseidon2 as p2
from .opcode import (
    ALU_OPCODES,
    BRANCH_OPCODES,
    JUMP_OPCODES,
    LOAD_OPCODES,
    MEM_OPCODES,
    Opcode,
    STORE_OPCODES,
    SyscallCode,
)
from .program import NUM_REGISTERS, REG_A0, REG_A1, REG_V0, sign_extend
from .record import ExecutionRecord
from ..trace import span

M32 = 0xFFFFFFFF

# Weierstrass curve parameters: syscall -> (modulus, curve a, is_add)
_P256K1 = (1 << 256) - (1 << 32) - 977
_P256R1 = (1 << 256) - (1 << 224) + (1 << 192) + (1 << 96) - 1
_PBN254 = 21888242871839275222246405745257275088696311157297823662689037894645226208583
_P25519 = (1 << 255) - 19
_ED25519_D = 37095705934669439343138083508754565189542113879843219016388785533085940283555

# Weierstrass decompress curves: syscall -> (p, a, b, words, lexicographic)
# (reference: crates/curves/src/weierstrass/{secp256k1,secp256r1,bls12_381}.rs)
_P256K1 = (1 << 256) - (1 << 32) - 977
_P256R1 = (1 << 256) - (1 << 224) + (1 << 192) + (1 << 96) - 1
_PBLS = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab", 16
)
_B256R1 = int(
    "5ac635d8aa3a93e7b3ebbd55769886bc651d06b0cc53b0f63bce3c3e27d2604b", 16
)
_WEIERSTRASS_DECOMPRESS = {
    SyscallCode.SECP256K1_DECOMPRESS: (_P256K1, 0, 7, 8, False),
    SyscallCode.SECP256R1_DECOMPRESS: (_P256R1, _P256R1 - 3, _B256R1, 8, False),
    SyscallCode.BLS12381_DECOMPRESS: (_PBLS, 0, 4, 12, True),
}
_PBLS = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab", 16
)
# Fp / Fp2 tower ops: syscall -> (modulus, words per element, op, is_fp2)
_FPOPS = {
    SyscallCode.BLS12381_FP_ADD: (_PBLS, 12, "add", False),
    SyscallCode.BLS12381_FP_SUB: (_PBLS, 12, "sub", False),
    SyscallCode.BLS12381_FP_MUL: (_PBLS, 12, "mul", False),
    SyscallCode.BLS12381_FP2_ADD: (_PBLS, 12, "add", True),
    SyscallCode.BLS12381_FP2_SUB: (_PBLS, 12, "sub", True),
    SyscallCode.BLS12381_FP2_MUL: (_PBLS, 12, "mul", True),
    SyscallCode.BN254_FP_ADD: (_PBN254, 8, "add", False),
    SyscallCode.BN254_FP_SUB: (_PBN254, 8, "sub", False),
    SyscallCode.BN254_FP_MUL: (_PBN254, 8, "mul", False),
    SyscallCode.BN254_FP2_ADD: (_PBN254, 8, "add", True),
    SyscallCode.BN254_FP2_SUB: (_PBN254, 8, "sub", True),
    SyscallCode.BN254_FP2_MUL: (_PBN254, 8, "mul", True),
}
_WEIERSTRASS = {
    SyscallCode.SECP256K1_ADD: (_P256K1, 0, True, 8),
    SyscallCode.SECP256K1_DOUBLE: (_P256K1, 0, False, 8),
    SyscallCode.SECP256R1_ADD: (_P256R1, _P256R1 - 3, True, 8),
    SyscallCode.SECP256R1_DOUBLE: (_P256R1, _P256R1 - 3, False, 8),
    SyscallCode.BN254_ADD: (_PBN254, 0, True, 8),
    SyscallCode.BN254_DOUBLE: (_PBN254, 0, False, 8),
    SyscallCode.BLS12381_ADD: (_PBLS, 0, True, 12),
    SyscallCode.BLS12381_DOUBLE: (_PBLS, 0, False, 12),
}
_SHA256_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
POS_MEMORY, POS_C, POS_B, POS_A, POS_HI = 0, 1, 2, 3, 4
_POS_NAME = {POS_MEMORY: "mem", POS_C: "c", POS_B: "b", POS_A: "a", POS_HI: "hi"}


def _s32(x):
    x &= M32
    return x - (1 << 32) if x & 0x80000000 else x


class ExecutionError(Exception):
    pass


class Halted(Exception):
    pass


class Executor:
    def __init__(self, program, stdin: list | None = None, max_cycles=None,
                 mode="trace", shard_size=None, hook_registry=None):
        from .hooks import HookRegistry

        self.program = program
        self.mode = mode
        self.max_cycles = max_cycles
        # host hooks: guest WRITEs to reserved fds call back into the host
        # (reference: hook.rs HookRegistry; ecrecover / fp sqrt+inv hints)
        self.hook_registry = hook_registry or HookRegistry.default()
        # continuation: split execution into shards of <= shard_size cycles
        # (reference: executor.rs shard splitting; branch + delay slot are
        # kept in the same shard)
        self.shard_size = shard_size
        self.records: list[ExecutionRecord] = []
        self.shard_cycles = 0
        self.next_is_delayslot = False
        # per-shard first/last access tracking for the MemoryLocal chip:
        # addr -> (prev_shard, prev_clk, prev_value) at first in-shard access
        self.shard_initial: dict[int, tuple] = {}
        # unified address space: addr -> [value, last_clk, last_shard]
        self.memory: dict[int, list] = {
            addr: [v & M32, 0, 0] for addr, v in program.image.items()
        }
        self.shard = 1
        # hint-written values adopted as init values on first access
        # (reference: syscalls/hint.rs writes state.uninitialized_memory)
        self.uninitialized_memory: dict[int, int] = {}
        self.pc = program.pc_start
        self.next_pc = (program.pc_start + 4) & M32
        self.clk = 0
        self.global_clk = 0
        self.exited = False
        self.exit_code = 0
        # hint input stream (io::read): list of byte buffers
        self.input_stream: list[bytes] = list(stdin or [])
        self.input_stream_ptr = 0
        self.hint_lens: list[int] = []
        # output
        self.committed_values: list[int] = []  # words committed via COMMIT
        self.deferred_digest: list[int] = []  # COMMIT_DEFERRED_PROOFS words
        self.stdout = bytearray()
        # bytes written to FD_PUBLIC_VALUES=3 (reference write.rs:57: the
        # public values stream whose sha256 the guest commits at halt)
        self.public_values_stream = bytearray()
        self.record = ExecutionRecord(program)
        self.touched: dict[int, int] = {}  # addr -> init value (first touch)
        self.report = {"opcode_counts": {}, "syscall_counts": {}}
        self._accesses = {}
        # unconstrained blocks (reference: syscalls/unconstrained.rs): the
        # block runs untraced, all state is reverted at EXIT except the hint
        # stream, and the ENTER instruction re-executes returning 0
        self.unconstrained = False
        self._uc = None
        self._uc_completed = False
        # per-cycle pc trace dump for the cycle tracer (reference
        # executor.rs:307-315 TRACE_FILE: one u32 big-endian pc per
        # constrained cycle, file created at construction)
        self._trace_buf = None
        trace_file = os.environ.get("ZIREN_TRACE_FILE") or os.environ.get(
            "TRACE_FILE"
        )
        if trace_file:
            self._trace_buf = open(trace_file, "wb")
        self._suppress_event = False
        # deferred sub-proof verification (reference: proof_stream on state)
        self.proof_stream: list = []
        self.proof_stream_ptr = 0
        self.subproof_verifier = None
        # guest cycle tracking (reference: executor.rs cycle_tracker)
        self.cycle_tracker: dict[str, int] = {}
        self._tracker_open: dict[str, int] = {}
        # shard-boundary checkpoints (reference: Checkpoint executor mode)
        self.collect_checkpoints = False
        self.checkpoints: list = []

    # -- memory primitives -------------------------------------------------
    def _touch(self, addr, rec):
        if addr not in self.touched:
            self.touched[addr] = rec[0]
        if addr not in self.shard_initial:
            self.shard_initial[addr] = (rec[2], rec[1], rec[0])

    def _read(self, addr: int, position: int) -> int:
        rec = self.memory.get(addr)
        if rec is None:
            rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
            self.memory[addr] = rec
        self._touch(addr, rec)
        ts = self.clk + position
        prev_clk, prev_shard = rec[1], rec[2]
        value = rec[0]
        rec[1] = ts
        rec[2] = self.shard
        if self.mode == "trace":
            self._accesses[_POS_NAME[position]] = (
                addr, value, prev_clk, prev_shard, value, False
            )
        return value

    def _write(self, addr: int, value: int, position: int) -> int:
        value &= M32
        if addr == 0:
            value = 0  # register $zero is hard-wired (reference: rw_cpu)
        rec = self.memory.get(addr)
        if rec is None:
            rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
            self.memory[addr] = rec
        self._touch(addr, rec)
        ts = self.clk + position
        prev_clk, prev_value, prev_shard = rec[1], rec[0], rec[2]
        rec[0] = value
        rec[1] = ts
        rec[2] = self.shard
        if self.mode == "trace":
            self._accesses[_POS_NAME[position]] = (
                addr, prev_value, prev_clk, prev_shard, value, True
            )
        return prev_value

    def peek_register(self, reg: int) -> int:
        rec = self.memory.get(reg)
        return rec[0] if rec else 0

    def peek_word(self, addr: int) -> int:
        rec = self.memory.get(addr)
        return rec[0] if rec else 0

    # -- fetch/decode/execute ---------------------------------------------
    def fetch(self):
        instr = self.program.instruction_at(self.pc)
        if instr is None:
            raise ExecutionError(f"pc out of program range: {self.pc:#x}")
        return instr

    def _operands_bc(self, instr, pos_b=POS_B, pos_c=POS_C):
        """Read b (register or imm) and c in reference operand order (C first)."""
        if instr.imm_c:
            c = instr.op_c & M32
        else:
            c = self._read(instr.op_c, pos_c)
        if instr.imm_b:
            b = instr.op_b & M32
        else:
            b = self._read(instr.op_b, pos_b)
        return b, c

    def execute_cycle(self) -> bool:
        instr = self.fetch()
        op = instr.opcode
        if self._trace_buf is not None and not self.unconstrained:
            self._trace_buf.write(struct.pack(">I", self.pc))
        self.report["opcode_counts"][op] = self.report["opcode_counts"].get(op, 0) + 1
        self._accesses = {}
        clk, pc, next_pc = self.clk, self.pc, self.next_pc
        next_next_pc = (next_pc + 4) & M32
        a = b = c = 0
        prev_a = 0
        syscall_code = 0
        exit_code = 0

        if op in ALU_OPCODES:
            b, c = self._operands_bc(instr)
            a, hi = self._alu(op, b, c)
            if op in (Opcode.DIV, Opcode.DIVU, Opcode.MOD, Opcode.MODU) and c == 0:
                raise ExecutionError("division by zero")
            if op in (Opcode.MULT, Opcode.MULTU, Opcode.DIV, Opcode.DIVU):
                self._write(33, hi, POS_HI)  # HI register
                prev_a = hi  # hi_or_prev_a carries HI for mult/div family
            self._write(instr.op_a, a, POS_A)
        elif op in BRANCH_OPCODES:
            b, c = self._operands_bc(instr)  # src2, offset
            src1 = self._read(instr.op_a, POS_A)
            a = src1
            taken = {
                Opcode.BEQ: src1 == b,
                Opcode.BNE: src1 != b,
                Opcode.BGEZ: _s32(src1) >= 0,
                Opcode.BLEZ: _s32(src1) <= 0,
                Opcode.BGTZ: _s32(src1) > 0,
                Opcode.BLTZ: _s32(src1) < 0,
            }[op]
            if taken:
                next_next_pc = (c + next_pc) & M32
        elif op in JUMP_OPCODES:
            return_pc = (self.next_pc + 4) & M32
            if op == Opcode.Jump:
                target = self._read(instr.op_b, POS_B)
                b = target
                next_next_pc = target
            elif op == Opcode.Jumpi:
                b = instr.op_b & M32
                next_next_pc = b
            else:  # JumpDirect
                b = instr.op_b & M32
                next_next_pc = (b + self.next_pc) & M32
            a = return_pc
            self._write(instr.op_a, return_pc, POS_A)
        elif op in MEM_OPCODES:
            rs_raw = self._read(instr.op_b, POS_B)
            offset = instr.op_c & M32
            addr = (rs_raw + offset) & M32
            aligned = addr & ~3
            assert aligned >= 0x1000, f"guest memory access below 0x1000: {addr:#x}"
            assert aligned < 0x7F000000, f"guest memory access above MAX_MEMORY: {addr:#x}"
            b, c = rs_raw, offset
            if op in LOAD_OPCODES:
                rt = self.peek_register(instr.op_a)
                mem = self._read(aligned, POS_MEMORY)
                a = self._load_value(op, addr, mem, rt)
                prev_a = self._write(instr.op_a, a, POS_A)
            else:
                if op == Opcode.SC:
                    rt = self.peek_register(instr.op_a)
                else:
                    rt = self._read(instr.op_a, POS_A)
                mem = self.peek_word(aligned)
                val = self._store_value(op, addr, mem, rt)
                self._write(aligned, val, POS_MEMORY)
                if op == Opcode.SC:
                    prev_a = self._write(instr.op_a, 1, POS_A)
                    a = 1
                else:
                    a = rt
                    prev_a = rt
        elif op == Opcode.SYSCALL:
            syscall_id = self.peek_register(REG_V0)
            c = self._read(REG_A1, POS_C)
            b = self._read(REG_A0, POS_B)
            prev_a = syscall_id
            syscall_code = syscall_id
            a, next_pc_override, extra_cycles, exit_code = self._syscall(
                syscall_id, b, c
            )
            self._write(REG_V0, a, POS_A)
            if next_pc_override is not None:
                next_pc = next_pc_override
                next_next_pc = (next_pc_override + 4) & M32
            else:
                next_pc = self.next_pc
                next_next_pc = (next_pc + 4) & M32
            self.clk += extra_cycles
        elif op in (Opcode.MEQ, Opcode.MNE):
            a_old = self.peek_register(instr.op_a)
            c = self._read(instr.op_c, POS_C)
            b = self._read(instr.op_b, POS_B)
            mov = (c == 0) if op == Opcode.MEQ else (c != 0)
            a = b if mov else a_old
            prev_a = self._write(instr.op_a, a, POS_A)
        elif op == Opcode.SEXT:
            b, c = self._read(instr.op_b, POS_B), instr.op_c
            a = sign_extend(b & 0xFFFF, 16) if c > 0 else sign_extend(b & 0xFF, 8)
            self._write(instr.op_a, a, POS_A)
        elif op == Opcode.WSBH:
            b = self._read(instr.op_b, POS_B)
            a = (
                (((b >> 16) & 0xFF) << 24)
                | (((b >> 24) & 0xFF) << 16)
                | ((b & 0xFF) << 8)
                | ((b >> 8) & 0xFF)
            )
            self._write(instr.op_a, a, POS_A)
        elif op == Opcode.EXT:
            b = self._read(instr.op_b, POS_B)
            c = instr.op_c
            msbd, lsb = c >> 5, c & 0x1F
            mask = M32 if msbd + lsb + 1 == 32 else (1 << (msbd + lsb + 1)) - 1
            a = (b & mask) >> lsb
            self._write(instr.op_a, a, POS_A)
        elif op == Opcode.INS:
            b = self._read(instr.op_b, POS_B)
            c = instr.op_c
            a_old = self.peek_register(instr.op_a)
            msb, lsb = c >> 5, c & 0x1F
            mask = M32 if msb - lsb + 1 == 32 else (1 << (msb - lsb + 1)) - 1
            mf = (mask << lsb) & M32
            a = (a_old & ~mf) | ((b << lsb) & mf)
            prev_a = self._write(instr.op_a, a, POS_A)
        elif op == Opcode.TEQ:
            b = self._read(instr.op_b, POS_B)
            a = self._read(instr.op_a, POS_A)
            if a == b:
                raise ExecutionError("TEQ trap")
        elif op in (Opcode.MADDU, Opcode.MSUBU, Opcode.MADD, Opcode.MSUB):
            c = self._read(instr.op_c, POS_C)
            b = self._read(instr.op_b, POS_B)
            lo_val = self.peek_register(32)
            hi_val = self.peek_register(33)
            acc = (hi_val << 32) | lo_val
            if op in (Opcode.MADDU, Opcode.MSUBU):
                m = b * c
            else:
                m = _s32(b) * _s32(c)
            out = (acc + m) if op in (Opcode.MADDU, Opcode.MADD) else (acc - m)
            out &= (1 << 64) - 1
            a = out & M32
            prev_a = self._write(instr.op_a, a, POS_A)
            self._write(33, (out >> 32) & M32, POS_HI)
            prev_a = lo_val
        elif op == Opcode.UNIMPL:
            raise ExecutionError(f"unimplemented instruction {instr.op_c:#x}")
        else:
            raise ExecutionError(f"unhandled opcode {op}")

        if next_next_pc == 0:
            raise ExecutionError("null pointer reference")

        if self._suppress_event:
            self._suppress_event = False
        elif self.mode == "trace":
            self.record.append_cycle(
                clk=clk,
                pc=pc,
                next_pc=next_pc,
                next_next_pc=next_next_pc,
                instr_idx=(pc - self.program.pc_base) // 4,
                a=a,
                b=b,
                c=c,
                prev_a=prev_a,
                exit_code=exit_code,
                syscall_code=syscall_code,
                accesses=self._accesses,
            )

        self.pc = next_pc
        self.next_pc = next_next_pc
        self.clk += 5
        self.global_clk += 1
        self.shard_cycles += 1
        self.next_is_delayslot = op in BRANCH_OPCODES or op in JUMP_OPCODES

        if self.max_cycles and self.global_clk >= self.max_cycles:
            raise ExecutionError("exceeded cycle limit")

        done = (
            self.pc == 0
            or self.exited
            or (self.pc - self.program.pc_base) >= len(self.program.instructions) * 4
        )
        if (
            not done
            and self.shard_size
            and self.shard_cycles >= self.shard_size
            and not self.next_is_delayslot
            and not self.unconstrained  # blocks never straddle shards
        ):
            self._bump_shard()
        return done

    def run_shard(self):
        """Run exactly one shard (until the next shard boundary or program
        end); returns that shard's record. Used with `recover` to regenerate
        any shard's trace from its checkpoint."""
        start = self.shard
        self.shard_start_pc = self.pc
        done = False
        while not done and self.shard == start:
            done = self.execute_cycle()
        if done and self.shard == start:
            self.postprocess()
            return self.record
        return self.records[-1]

    def _bump_shard(self):
        """Close the current shard record and start the next one."""
        rec = self.record
        pv = rec.public_values
        pv.start_pc = self.shard_start_pc
        pv.next_pc = self.pc
        pv.shard = self.shard
        pv.execution_shard = self.shard
        rec.shard_initial = dict(self.shard_initial)
        rec.shard_final = {
            addr: (self.memory[addr][2], self.memory[addr][1], self.memory[addr][0])
            for addr in self.shard_initial
        }
        self.records.append(rec)
        self.record = ExecutionRecord(self.program)
        self.shard_initial = {}
        self.shard += 1
        self.clk = 0
        self.shard_cycles = 0
        self.shard_start_pc = self.pc
        if self.collect_checkpoints:
            self.checkpoints.append(self.checkpoint())

    # -- checkpoint / resume (reference: executor.rs Checkpoint mode +
    # Executor::recover — the minimal ExecutionState snapshot from which a
    # shard's full trace can be regenerated) --------------------------------
    def checkpoint(self) -> dict:
        """Minimal resumable state at a shard boundary (picklable)."""
        return {
            "pc": self.pc,
            "next_pc": self.next_pc,
            "clk": self.clk,
            "global_clk": self.global_clk,
            "shard": self.shard,
            "shard_cycles": self.shard_cycles,
            "memory": {a: list(r) for a, r in self.memory.items()},
            "uninitialized_memory": dict(self.uninitialized_memory),
            "touched": dict(self.touched),
            "input_stream": list(self.input_stream),
            "input_stream_ptr": self.input_stream_ptr,
            "committed_values": list(self.committed_values),
            "deferred_digest": list(self.deferred_digest),
            "public_values_stream": bytes(self.public_values_stream),
            "proof_stream_ptr": self.proof_stream_ptr,
        }

    @classmethod
    def recover(cls, program, state: dict, mode="trace", shard_size=None):
        """Rebuild an executor from a checkpoint; re-running regenerates the
        exact trace from that point (reference: executor.rs:381-390)."""
        ex = cls(program, mode=mode, shard_size=shard_size)
        ex.pc = state["pc"]
        ex.next_pc = state["next_pc"]
        ex.clk = state["clk"]
        ex.global_clk = state["global_clk"]
        ex.shard = state["shard"]
        ex.shard_cycles = state["shard_cycles"]
        ex.memory = {a: list(r) for a, r in state["memory"].items()}
        ex.uninitialized_memory = dict(state["uninitialized_memory"])
        ex.touched = dict(state["touched"])
        ex.input_stream = list(state["input_stream"])
        ex.input_stream_ptr = state["input_stream_ptr"]
        ex.committed_values = list(state["committed_values"])
        ex.deferred_digest = list(state["deferred_digest"])
        ex.public_values_stream = bytearray(
            state.get("public_values_stream", b"")
        )
        ex.proof_stream_ptr = state["proof_stream_ptr"]
        ex.shard_start_pc = ex.pc
        return ex

    def run(self):
        self.shard_start_pc = self.pc
        try:
            while not self.execute_cycle():
                pass
            self.postprocess()
        finally:
            if self._trace_buf is not None:  # the pc trace is whole once run returns
                self._trace_buf.close()
                self._trace_buf = None
        return self.record

    def run_sharded(self) -> list:
        """Execute and return the list of shard records."""
        assert self.shard_size, "run_sharded requires shard_size"
        with span("executor") as sp:
            try:
                self.shard_start_pc = self.pc
                while not self.execute_cycle():
                    pass
                self._bump_shard()  # close the final shard
                records = self.records
                # memory init/finalize events live in the last record
                last = records[-1]
                for addr, init_value in sorted(self.touched.items()):
                    rec = self.memory[addr]
                    last.mem_init.append((addr, init_value))
                    last.mem_final.append((addr, rec[2], rec[1], rec[0]))
                # every shard shares the final committed digest
                digest = list(self.committed_values[:8]) + [0] * max(
                    0, 8 - len(self.committed_values)
                )
                deferred = list(self.deferred_digest[:8]) + [0] * max(
                    0, 8 - len(self.deferred_digest)
                )
                for rec in records:
                    rec.public_values.committed_value_digest = list(digest)
                    rec.public_values.deferred_proofs_digest = list(deferred)
                    rec.public_values.exit_code = self.exit_code
                # deferred-event split: move large init/finalize sets into
                # standalone memory shards + populate the addr-bits pv chain
                from .split import finalize_memory

                with span("executor.finalize"):
                    self.records = finalize_memory(records)
            finally:
                if self._trace_buf is not None:  # whole once run_sharded returns
                    self._trace_buf.close()
                    self._trace_buf = None
            sp.set(cycles=int(self.global_clk), shards=len(self.records))
        return self.records

    def postprocess(self):
        if self._trace_buf is not None:
            self._trace_buf.flush()
        self.record.shard_initial = dict(self.shard_initial)
        self.record.shard_final = {
            addr: (self.memory[addr][2], self.memory[addr][1], self.memory[addr][0])
            for addr in self.shard_initial
        }
        # memory finalize events for all touched addresses
        for addr, init_value in sorted(self.touched.items()):
            rec = self.memory[addr]
            self.record.mem_init.append((addr, init_value))
            self.record.mem_final.append((addr, rec[2], rec[1], rec[0]))
        pv = self.record.public_values
        # a recovered executor finalizes its own (non-first) shard
        pv.start_pc = getattr(self, "shard_start_pc", self.program.pc_start) \
            if self.shard > 1 else self.program.pc_start
        pv.next_pc = self.pc
        pv.exit_code = self.exit_code
        pv.shard = self.shard
        pv.execution_shard = self.shard
        digest = list(self.committed_values[:8]) + [0] * max(
            0, 8 - len(self.committed_values)
        )
        pv.committed_value_digest = digest
        pv.deferred_proofs_digest = list(self.deferred_digest[:8]) + [0] * max(
            0, 8 - len(self.deferred_digest)
        )
        # this record carries the memory endpoints: bind the addr-bit chain
        from .split import ensure_zero_address, set_last_memory_bits

        ensure_zero_address(self.record)
        set_last_memory_bits(self.record)

    # -- ALU semantics -----------------------------------------------------
    @staticmethod
    def _alu(op, b, c):
        s = _s32
        if op == Opcode.ADD:
            return (b + c) & M32, 0
        if op == Opcode.SUB:
            return (b - c) & M32, 0
        if op == Opcode.SLL:
            return (b << (c & 0x1F)) & M32, 0
        if op == Opcode.SRL:
            return (b >> (c & 0x1F)) & M32, 0
        if op == Opcode.SRA:
            return (s(b) >> (c & 0x1F)) & M32, 0
        if op == Opcode.ROR:
            sh = c & 0x1F
            return ((b >> sh) | (b << (32 - sh))) & M32 if sh else b, 0
        if op == Opcode.MUL:
            return (b * c) & M32, 0
        if op == Opcode.SLT:
            return int(s(b) < s(c)), 0
        if op == Opcode.SLTU:
            return int(b < c), 0
        if op == Opcode.MULT:
            out = (s(b) * s(c)) & ((1 << 64) - 1)
            return out & M32, (out >> 32) & M32
        if op == Opcode.MULTU:
            out = b * c
            return out & M32, (out >> 32) & M32
        if op == Opcode.DIV:
            q = abs(s(b)) // abs(s(c)) if c != 0 else 0
            if (s(b) < 0) != (s(c) < 0):
                q = -q
            r = s(b) - q * s(c)
            return q & M32, r & M32
        if op == Opcode.DIVU:
            return (b // c) & M32, (b % c) & M32
        if op == Opcode.MOD:
            q = abs(s(b)) // abs(s(c)) if c != 0 else 0
            if (s(b) < 0) != (s(c) < 0):
                q = -q
            return (s(b) - q * s(c)) & M32, 0
        if op == Opcode.MODU:
            return (b % c) & M32, 0
        if op == Opcode.AND:
            return b & c, 0
        if op == Opcode.OR:
            return b | c, 0
        if op == Opcode.XOR:
            return b ^ c, 0
        if op == Opcode.NOR:
            return (~(b | c)) & M32, 0
        if op == Opcode.CLZ:
            return 32 - b.bit_length(), 0
        if op == Opcode.CLO:
            return 32 - ((~b) & M32).bit_length(), 0
        raise ExecutionError(f"bad alu op {op}")

    @staticmethod
    def _load_value(op, addr, mem, rt):
        i = addr & 3
        if op == Opcode.LW or op == Opcode.LL:
            assert addr & 3 == 0, "unaligned LW"
            return mem
        if op == Opcode.LB:
            return sign_extend((mem >> (i * 8)) & 0xFF, 8)
        if op == Opcode.LBU:
            return (mem >> (i * 8)) & 0xFF
        if op == Opcode.LH:
            assert addr & 1 == 0, "unaligned LH"
            return sign_extend((mem >> ((addr & 2) * 8)) & 0xFFFF, 16)
        if op == Opcode.LHU:
            return (mem >> ((addr & 2) * 8)) & 0xFFFF
        if op == Opcode.LWL:
            val = (mem << (24 - i * 8)) & M32
            mask = (0xFFFFFFFF << (24 - i * 8)) & M32
            return (rt & ~mask) | val
        if op == Opcode.LWR:
            val = mem >> (i * 8)
            mask = 0xFFFFFFFF >> (i * 8)
            return ((rt & ~mask) | val) & M32
        raise ExecutionError(f"bad load {op}")

    @staticmethod
    def _store_value(op, addr, mem, rt):
        i = addr & 3
        if op in (Opcode.SW, Opcode.SC):
            assert addr & 3 == 0, "unaligned SW"
            return rt
        if op == Opcode.SB:
            mask = M32 ^ (0xFF << (i * 8))
            return (mem & mask) | ((rt & 0xFF) << (i * 8))
        if op == Opcode.SH:
            assert addr & 1 == 0, "unaligned SH"
            sh = (addr & 2) * 8
            mask = M32 ^ (0xFFFF << sh)
            return (mem & mask) | ((rt & 0xFFFF) << sh)
        if op == Opcode.SWL:
            val = rt >> (24 - i * 8)
            mask = 0xFFFFFFFF >> (24 - i * 8)
            return ((mem & ~mask) | val) & M32
        if op == Opcode.SWR:
            val = (rt << (i * 8)) & M32
            mask = (0xFFFFFFFF << (i * 8)) & M32
            return ((mem & ~mask) | val) & M32
        raise ExecutionError(f"bad store {op}")

    # -- syscalls ----------------------------------------------------------
    def _syscall(self, syscall_id, b, c):
        """Returns (a, next_pc_override, extra_cycles, exit_code)."""
        self.report["syscall_counts"][syscall_id] = (
            self.report["syscall_counts"].get(syscall_id, 0) + 1
        )
        if syscall_id == SyscallCode.HALT:
            self.exited = True
            self.exit_code = b
            if b != 0:
                raise ExecutionError(f"halt with nonzero exit code {b}")
            return syscall_id, 0, 0, b
        if syscall_id == SyscallCode.WRITE:
            fd, write_buf, nbytes = b, c, self.peek_register(6)  # A2
            data = bytearray()
            for i in range(nbytes):
                w = self.peek_word((write_buf + i) & ~3)
                data.append((w >> (((write_buf + i) & 3) * 8)) & 0xFF)
            if fd == 3:
                # FD_PUBLIC_VALUES: the public values stream (reference
                # write.rs:57); the guest commits its sha256 at halt
                self.public_values_stream.extend(data)
            elif fd in (1, 2):
                # guest cycle-tracker markers (reference: syscalls/write.rs
                # "cycle-tracker-start/end: <name>") are intercepted into the
                # cycle_tracker map instead of stdout
                text = data.decode("utf-8", "replace").strip()
                if text.startswith("cycle-tracker-start:"):
                    name = text.split(":", 1)[1].strip()
                    self._tracker_open[name] = self.global_clk
                elif text.startswith("cycle-tracker-end:"):
                    name = text.split(":", 1)[1].strip()
                    start = self._tracker_open.pop(name, None)
                    if start is not None:
                        self.cycle_tracker[name] = (
                            self.cycle_tracker.get(name, 0)
                            + (self.global_clk - start)
                        )
                else:
                    self.stdout.extend(data)
            elif fd == 4:
                # hint fd: becomes the next HINT_LEN/HINT_READ buffer
                # (reference: io.rs write_fd FD_HINT)
                self.input_stream.append(bytes(data))
            elif self.hook_registry.get(fd) is not None:
                # host hook: result buffers become the next hint reads
                # (reference: hook.rs HookRegistry, executor.rs hook fds)
                for out in self.hook_registry.get(fd)(self, bytes(data)):
                    self.input_stream.append(bytes(out))
            return nbytes, None, 0, 0
        if syscall_id == SyscallCode.COMMIT:
            # word_idx = b, word = c
            while len(self.committed_values) <= b:
                self.committed_values.append(0)
            self.committed_values[b] = c
            return syscall_id, None, 0, 0
        if syscall_id == SyscallCode.COMMIT_DEFERRED_PROOFS:
            # word_idx = b, word = c (poseidon digest of deferred proofs)
            while len(self.deferred_digest) <= b:
                self.deferred_digest.append(0)
            self.deferred_digest[b] = c
            return syscall_id, None, 0, 0
        if syscall_id == SyscallCode.POSEIDON2_PERMUTE:
            # permute 16 KoalaBear words in place at ptr = b
            # (reference: syscalls/precompiles/poseidon2) — reads at clk,
            # writes at clk + 1, one extra cycle
            ptr = b
            assert ptr % 4 == 0, "poseidon2 state must be word-aligned"
            ev = {"shard": self.shard, "clk": self.clk, "ptr": ptr,
                  "reads": [], "writes": []}
            state = []
            for i in range(16):
                addr = (ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                assert rec[0] < p2.P, "poseidon2 input must be canonical"
                state.append(rec[0])
                rec[1] = self.clk
                rec[2] = self.shard
            out = p2.permute(np.asarray(state, dtype=np.uint32))
            for i in range(16):
                addr = (ptr + 4 * i) & M32
                rec = self.memory[addr]
                ev["writes"].append((addr, rec[0], rec[1], rec[2], int(out[i])))
                rec[0] = int(out[i])
                rec[1] = self.clk + 1
                rec[2] = self.shard
            self.record.precompile_events.setdefault(
                int(SyscallCode.POSEIDON2_PERMUTE), []
            ).append(ev)
            return syscall_id, None, 1, 0
        if syscall_id == SyscallCode.BOOLEAN_CIRCUIT_GARBLE:
            # garbled-circuit ciphertext check (reference:
            # precompiles/boolean_circuit/garble.rs): per gate (17 u32s:
            # type, h0[4], h1[4], label_b[4], expected_ct[4]), the computed
            # ct is h0^h1^label (^delta for OR gates); result = all match.
            # Executor-level support; the AIR chip is tracked in ROADMAP.md.
            input_ptr, output_ptr = b, c
            ev = {"shard": self.shard, "clk": self.clk, "input_ptr": input_ptr,
                  "output_ptr": output_ptr, "reads": [], "writes": []}

            def _rd(addr):
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                rec[1] = self.clk
                rec[2] = self.shard
                return rec[0]

            num_gates = _rd(input_ptr & M32)
            assert 1 <= num_gates < (1 << 24), "garble gate count out of range"
            delta = [_rd((input_ptr + 4 + 4 * i) & M32) for i in range(4)]
            base = input_ptr + 20
            gates = [
                _rd((base + 4 * i) & M32) for i in range(17 * num_gates)
            ]
            result = 1
            for g in range(num_gates):
                o = 17 * g
                gtype = gates[o]
                for i in range(4):
                    ct = gates[o + 1 + i] ^ gates[o + 5 + i] ^ gates[o + 9 + i]
                    if gtype != 0:
                        ct ^= delta[i]
                    if ct != gates[o + 13 + i]:
                        result = 0
            addr = output_ptr & M32
            rec = self.memory.get(addr)
            if rec is None:
                rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                self.memory[addr] = rec
            self._touch(addr, rec)
            ev["writes"].append((addr, rec[0], rec[1], rec[2], result))
            rec[0] = result
            rec[1] = self.clk
            rec[2] = self.shard
            ev["output"] = result
            self.record.precompile_events.setdefault(
                int(syscall_id), []
            ).append(ev)
            return syscall_id, None, 0, 0
        if syscall_id == SyscallCode.VERIFY_ZKM_PROOF:
            # defer a sub-proof claim: vkey digest at b, pv digest at c
            # (reference: syscalls/verify.rs — unsafe word reads, no memory
            # records; verification happens host-side / in the recursion
            # layer, the claim folds into pv.deferred_proofs_digest)
            assert b % 4 == 0 and c % 4 == 0, "verify ptrs unaligned"
            vkey = tuple(self.peek_word((b + 4 * i) & M32) for i in range(8))
            pvd = tuple(self.peek_word((c + 4 * i) & M32) for i in range(8))
            idx = self.proof_stream_ptr
            if self.subproof_verifier is not None:
                assert idx < len(self.proof_stream), "not enough proofs written"
                proof, proof_vk = self.proof_stream[idx]
                self.subproof_verifier(proof, proof_vk, vkey, pvd)
            self.proof_stream_ptr += 1
            self.record.deferred_proof_claims.append((vkey, pvd))
            return syscall_id, None, 0, 0
        if syscall_id == SyscallCode.ENTER_UNCONSTRAINED:
            if self._uc_completed:
                # replayed after EXIT restored state: take the constrained path
                self._uc_completed = False
                return 0, None, 0, 0
            assert not self.unconstrained, "nested unconstrained block"
            self.unconstrained = True
            snap_mem = {a: list(r) for a, r in self.memory.items()}
            # the ENTER cycle's own operand reads already stamped A0/A1;
            # rewind those records so the replayed ENTER sees pre-cycle state
            for acc in self._accesses.values():
                addr, prev_v, prev_clk, prev_shard = acc[0], acc[1], acc[2], acc[3]
                snap_mem[addr] = [prev_v, prev_clk, prev_shard]
            self._uc = {
                "memory": snap_mem,
                "touched": dict(self.touched),
                "shard_initial": dict(self.shard_initial),
                "clk": self.clk,
                "global_clk": self.global_clk,
                "shard_cycles": self.shard_cycles,
                "pc": self.pc,
                "next_pc": self.next_pc,
                "mode": self.mode,
                "pe_lens": {
                    k: len(v) for k, v in self.record.precompile_events.items()
                },
            }
            self.mode = "simple"
            return 1, None, 0, 0
        if syscall_id == SyscallCode.EXIT_UNCONSTRAINED:
            if self.unconstrained:
                s = self._uc
                self.memory = s["memory"]
                self.touched = s["touched"]
                self.shard_initial = s["shard_initial"]
                # the loop's end-of-cycle increments land back at the ENTER
                self.clk = s["clk"] - 5
                self.global_clk = s["global_clk"] - 1
                self.shard_cycles = s["shard_cycles"] - 1
                pe = self.record.precompile_events
                for k in list(pe.keys()):
                    n0 = s["pe_lens"].get(k, 0)
                    del pe[k][n0:]
                    if not pe[k]:
                        del pe[k]
                self.mode = s["mode"]
                self.unconstrained = False
                self._uc_completed = True
                self._suppress_event = True
                enter_pc = s["pc"]
                self._uc = None
                # keep V0 = the restored ENTER code so the replay dispatches
                return self.peek_register(REG_V0), enter_pc, 0, 0
            return 0, None, 0, 0
        if 4000 <= syscall_id < 4300:
            # Linux O32 ABI syscall emulation (reference: sys_linux/*.rs):
            # every variant records its register reads/writes and an A3
            # errno write into a LinuxEvent grouped under SYS_LINUX; the
            # SysLinux chip lands with the Linux-ABI milestone (ROADMAP.md)
            a0, a1 = b, c
            ev = {"shard": self.shard, "clk": self.clk, "a0": a0, "a1": a1,
                  "syscall_code": int(syscall_id), "reads": [], "writes": []}
            EBADF = 9

            def _reg_read(addr):
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [0, 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                rec[1] = self.clk
                rec[2] = self.shard
                return rec[0]

            def _reg_write(addr, value):
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [0, 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["writes"].append((addr, rec[0], rec[1], rec[2], value))
                rec[0] = value & M32
                rec[1] = self.clk
                rec[2] = self.shard

            next_pc_override = None
            if syscall_id == SyscallCode.SYS_BRK:
                brk = _reg_read(34)  # BRK register
                v0 = a0 if a0 > brk else brk
                _reg_write(7, 0)  # A3 errno
            elif syscall_id in (SyscallCode.SYS_MMAP, SyscallCode.SYS_MMAP2):
                size = a1
                if size & 0xFFF:
                    size = (size + 0x1000 - (size & 0xFFF)) & M32
                _reg_write(7, 0)
                if a0 == 0:
                    v0 = self.peek_register(35)  # HEAP
                    _reg_write(35, (v0 + size) & M32)
                else:
                    v0 = a0
            elif syscall_id == SyscallCode.SYS_CLONE:
                v0 = 1
                _reg_write(7, 0)
            elif syscall_id == SyscallCode.SYS_EXT_GROUP:
                self.exited = True
                self.exit_code = a0
                v0 = 0
                _reg_write(7, 0)
                next_pc_override = 0
            elif syscall_id == SyscallCode.SYS_READ:
                if a0 == 0:  # stdin
                    v0 = 0
                    _reg_write(7, 0)
                else:
                    v0 = 0xFFFFFFFF
                    _reg_write(7, EBADF)
            elif syscall_id == SyscallCode.SYS_WRITE:
                nbytes = _reg_read(6)  # A2
                data = bytearray()
                for i in range(nbytes):
                    w = self.peek_word((a1 + i) & ~3 & M32)
                    data.append((w >> (((a1 + i) & 3) * 8)) & 0xFF)
                if a0 in (1, 2):
                    self.stdout.extend(data)
                v0 = nbytes
                _reg_write(7, 0)
            elif syscall_id == SyscallCode.SYS_FCNTL:
                if a1 == 3:  # F_GETFL
                    if a0 == 0:
                        v0 = 0
                        _reg_write(7, 0)
                    elif a0 in (1, 2):
                        v0 = 1
                        _reg_write(7, 0)
                    else:
                        v0 = 0xFFFFFFFF
                        _reg_write(7, EBADF)
                elif a1 == 1:  # F_GETFD
                    if a0 in (0, 1, 2):
                        v0 = a0
                        _reg_write(7, 0)
                    else:
                        v0 = 0xFFFFFFFF
                        _reg_write(7, EBADF)
                else:
                    v0 = 0xFFFFFFFF
                    _reg_write(7, EBADF)
            else:
                # nop'd syscalls (open/close/sigaction/... reference mod.rs)
                v0 = 0
                _reg_write(7, 0)
            ev["v0"] = v0
            self.record.precompile_events.setdefault(
                int(SyscallCode.SYS_LINUX), []
            ).append(ev)
            return v0, next_pc_override, 0, self.exit_code
        if syscall_id == SyscallCode.U256XU2048_MUL:
            # 256-bit x 2048-bit multiply: (hi, lo) = a * b
            # (reference: precompiles/u256x2048_mul.rs — lo_ptr/hi_ptr come
            # from registers A2/A3 (traced reads), a + b read at clk,
            # lo (64 words) + hi (8 words) written at clk + 1; 1 extra cycle)
            a_ptr, b_ptr = b, c
            ev = {"shard": self.shard, "clk": self.clk, "a_ptr": a_ptr,
                  "b_ptr": b_ptr, "reads": [], "writes": []}

            def _rd(addr):
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                rec[1] = self.clk
                rec[2] = self.shard
                return rec[0]

            lo_ptr = _rd(6)  # register A2
            hi_ptr = _rd(7)  # register A3
            a_words = [_rd((a_ptr + 4 * i) & M32) for i in range(8)]
            b_words = [_rd((b_ptr + 4 * i) & M32) for i in range(64)]
            to_int = lambda ws: sum(int(w) << (32 * i) for i, w in enumerate(ws))
            prod = to_int(a_words) * to_int(b_words)
            lo_int, hi_int = prod & ((1 << 2048) - 1), prod >> 2048
            outs = [(lo_ptr + 4 * i, (lo_int >> (32 * i)) & M32) for i in range(64)]
            outs += [(hi_ptr + 4 * i, (hi_int >> (32 * i)) & M32) for i in range(8)]
            for addr, rv in outs:
                addr &= M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["writes"].append((addr, rec[0], rec[1], rec[2], rv))
                rec[0] = rv
                rec[1] = self.clk + 1
                rec[2] = self.shard
            self.record.precompile_events.setdefault(int(syscall_id), []).append(ev)
            return syscall_id, None, 1, 0
        if syscall_id in _FPOPS:
            # Fp / Fp2 tower field ops (reference: precompiles/fptower/ —
            # x at x_ptr reduced mod m, y read at clk, result written to
            # x_ptr at clk + 1, one extra cycle; inputs are reduced first)
            m, nwf, fop, is_fp2 = _FPOPS[syscall_id]
            nw_el = nwf * (2 if is_fp2 else 1)
            x_ptr, y_ptr = b, c
            assert x_ptr % 4 == 0 and y_ptr % 4 == 0, "fp op unaligned"
            ev = {"shard": self.shard, "clk": self.clk, "x_ptr": x_ptr,
                  "y_ptr": y_ptr, "reads": [], "writes": []}
            x_words = [self.peek_word((x_ptr + 4 * i) & M32) for i in range(nw_el)]
            y_words = []
            for i in range(nw_el):
                addr = (y_ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                y_words.append(rec[0])
                rec[1] = self.clk
                rec[2] = self.shard
            to_int = lambda ws: sum(int(w) << (32 * i) for i, w in enumerate(ws))

            def apply(a, b2):
                a, b2 = a % m, b2 % m
                if fop == "add":
                    return (a + b2) % m
                if fop == "sub":
                    return (a - b2) % m
                return (a * b2) % m

            if is_fp2:
                a0, a1 = to_int(x_words[:nwf]), to_int(x_words[nwf:])
                b0, b1 = to_int(y_words[:nwf]), to_int(y_words[nwf:])
                if fop == "mul":
                    r0 = (a0 * b0 - a1 * b1) % m
                    r1 = (a0 * b1 + a1 * b0) % m
                else:
                    r0, r1 = apply(a0, b0), apply(a1, b1)
                r_int = r0 | (r1 << (32 * nwf))
            else:
                r_int = apply(to_int(x_words), to_int(y_words))
            for i in range(nw_el):
                addr = (x_ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                rv = (r_int >> (32 * i)) & M32
                ev["writes"].append((addr, rec[0], rec[1], rec[2], rv))
                rec[0] = rv
                rec[1] = self.clk + 1
                rec[2] = self.shard
            self.record.precompile_events.setdefault(int(syscall_id), []).append(ev)
            return syscall_id, None, 1, 0
        if syscall_id == SyscallCode.ED_DECOMPRESS:
            # recover x from compressed (y, sign): x^2 = (y^2-1)/(d y^2+1),
            # x chosen with lsb == sign (reference: edwards/decompress.rs —
            # y read at ptr+32 at clk, x written at ptr at clk, 0 extra)
            m, d = _P25519, _ED25519_D
            ptr, sign = b, c
            assert ptr % 4 == 0, "ed_decompress ptr unaligned"
            assert sign <= 1, "sign bit must be 0 or 1"
            ev = {"shard": self.shard, "clk": self.clk, "ptr": ptr,
                  "sign": sign, "reads": [], "writes": []}
            y_words = []
            for i in range(8):
                addr = (ptr + 32 + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                y_words.append(rec[0])
                rec[1] = self.clk
                rec[2] = self.shard
            y = sum(int(w) << (32 * i) for i, w in enumerate(y_words))
            y &= (1 << 255) - 1  # bit 255 of the stored bytes is ignored
            assert y < m, "compressed y not canonical"
            num = (y * y - 1) % m
            den = (d * y * y + 1) % m
            xx = (num * pow(den, m - 2, m)) % m
            # sqrt mod p (p = 5 mod 8): candidate x = xx^((p+3)/8), fix by i
            x = pow(xx, (m + 3) // 8, m)
            if (x * x - xx) % m != 0:
                x = (x * pow(2, (m - 1) // 4, m)) % m
            assert (x * x - xx) % m == 0, "not a square: invalid point"
            if x & 1 != sign:
                x = (m - x) % m
            assert not (x == 0 and sign), "x = 0 with sign bit set"
            for i in range(8):
                addr = (ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                rv = (x >> (32 * i)) & M32
                ev["writes"].append((addr, rec[0], rec[1], rec[2], rv))
                rec[0] = rv
                rec[1] = self.clk
                rec[2] = self.shard
            self.record.precompile_events.setdefault(int(syscall_id), []).append(ev)
            return syscall_id, None, 0, 0
        if syscall_id in _WEIERSTRASS_DECOMPRESS:
            # recover y from (x, sign) on y^2 = x^3 + ax + b: x read at
            # ptr + nbytes, y written at ptr, 0 extra cycles (reference:
            # syscalls/precompiles/weierstrass/decompress.rs
            # create_ec_decompress_event). sign rule: parity of y for
            # secp256k1/secp256r1 (SEC1), lexicographically-largest y for
            # bls12-381 (ZCash flags; curves/src/weierstrass/bls12_381.rs).
            m, a_coef, b_coef, nw, lex = _WEIERSTRASS_DECOMPRESS[syscall_id]
            ptr, sign = b, c
            assert ptr % 4 == 0, "decompress ptr unaligned"
            assert sign <= 1, "sign bit must be 0 or 1"
            ev = {"shard": self.shard, "clk": self.clk, "ptr": ptr,
                  "sign": sign, "reads": [], "writes": []}
            x_words = []
            for i in range(nw):
                addr = (ptr + 4 * nw + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                x_words.append(rec[0])
                rec[1] = self.clk
                rec[2] = self.shard
            x = sum(int(w) << (32 * i) for i, w in enumerate(x_words))
            assert x < m, "compressed x not canonical"
            rhs = (x * x * x + a_coef * x + b_coef) % m
            y = pow(rhs, (m + 1) // 4, m)  # p = 3 mod 4 for all three
            assert (y * y - rhs) % m == 0, "x is not on the curve"
            if lex:
                assert y != 0, "2-torsion point has no lexicographic sign"
                if (y > m - y) != (sign == 1):
                    y = m - y
            elif (y & 1) != sign:
                y = m - y
            for i in range(nw):
                addr = (ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                rv = (y >> (32 * i)) & M32
                ev["writes"].append((addr, rec[0], rec[1], rec[2], rv))
                rec[0] = rv
                rec[1] = self.clk
                rec[2] = self.shard
            self.record.precompile_events.setdefault(int(syscall_id), []).append(ev)
            return syscall_id, None, 0, 0
        if syscall_id == SyscallCode.ED_ADD:
            # twisted Edwards (ed25519, a = -1) complete addition
            # (reference: syscalls/precompiles/edwards/add.rs — same event
            # shape as the weierstrass add: q read at clk, p overwritten at
            # clk + 1, one extra cycle)
            m = _P25519
            d = _ED25519_D
            p_ptr, q_ptr = b, c
            assert p_ptr % 4 == 0 and q_ptr % 4 == 0, "ed point unaligned"
            ev = {"shard": self.shard, "clk": self.clk, "p_ptr": p_ptr,
                  "q_ptr": q_ptr, "reads": [], "writes": []}
            p_words = [self.peek_word((p_ptr + 4 * i) & M32) for i in range(16)]
            to_int = lambda ws: sum(int(w) << (32 * i) for i, w in enumerate(ws))
            x1, y1 = to_int(p_words[:8]), to_int(p_words[8:])
            q_words = []
            for i in range(16):
                addr = (q_ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                q_words.append(rec[0])
                rec[1] = self.clk
                rec[2] = self.shard
            x2, y2 = to_int(q_words[:8]), to_int(q_words[8:])
            den = (d * x1 * x2 * y1 * y2) % m
            x3 = ((x1 * y2 + x2 * y1) * pow(1 + den, m - 2, m)) % m
            y3 = ((y1 * y2 + x1 * x2) * pow(1 - den, m - 2, m)) % m
            out = [(x3 >> (32 * i)) & M32 for i in range(8)] + [
                (y3 >> (32 * i)) & M32 for i in range(8)
            ]
            for i in range(16):
                addr = (p_ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["writes"].append((addr, rec[0], rec[1], rec[2], out[i]))
                rec[0] = out[i]
                rec[1] = self.clk + 1
                rec[2] = self.shard
            self.record.precompile_events.setdefault(int(syscall_id), []).append(ev)
            return syscall_id, None, 1, 0
        if syscall_id in _WEIERSTRASS:
            # affine Weierstrass point add / double (secp256k1/r1, bn254)
            # (reference: events/precompiles/ec.rs create_ec_add/double_event —
            # p read unsafely at p_ptr and overwritten with the result; add
            # reads q at clk and writes at clk + 1 with one extra cycle,
            # double writes at clk with no extra cycle)
            P256K, a_coef, is_add, nwc = _WEIERSTRASS[syscall_id]
            npt = 2 * nwc
            p_ptr, q_ptr = b, c
            assert p_ptr % 4 == 0, "ec point unaligned"
            ev = {"shard": self.shard, "clk": self.clk, "p_ptr": p_ptr,
                  "q_ptr": q_ptr if is_add else 0, "reads": [], "writes": []}
            p_words = [self.peek_word((p_ptr + 4 * i) & M32) for i in range(npt)]
            to_int = lambda ws: sum(int(w) << (32 * i) for i, w in enumerate(ws))
            x1, y1 = to_int(p_words[:nwc]), to_int(p_words[nwc:])
            if is_add:
                assert q_ptr % 4 == 0, "ec point unaligned"
                q_words = []
                for i in range(npt):
                    addr = (q_ptr + 4 * i) & M32
                    rec = self.memory.get(addr)
                    if rec is None:
                        rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                        self.memory[addr] = rec
                    self._touch(addr, rec)
                    ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                    q_words.append(rec[0])
                    rec[1] = self.clk
                    rec[2] = self.shard
                x2, y2 = to_int(q_words[:nwc]), to_int(q_words[nwc:])
                assert x1 != x2, "ec add requires distinct x (use double)"
                lam = ((y2 - y1) * pow(x2 - x1, P256K - 2, P256K)) % P256K
            else:
                lam = (
                    (3 * x1 * x1 + a_coef) * pow(2 * y1, P256K - 2, P256K)
                ) % P256K
                x2, y2 = x1, y1
            x3 = (lam * lam - x1 - x2) % P256K
            y3 = (lam * (x1 - x3) - y1) % P256K
            out = [(x3 >> (32 * i)) & M32 for i in range(nwc)] + [
                (y3 >> (32 * i)) & M32 for i in range(nwc)
            ]
            w_clk = self.clk + 1 if is_add else self.clk
            for i in range(npt):
                addr = (p_ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["writes"].append((addr, rec[0], rec[1], rec[2], out[i]))
                rec[0] = out[i]
                rec[1] = w_clk
                rec[2] = self.shard
            self.record.precompile_events.setdefault(int(syscall_id), []).append(ev)
            return syscall_id, None, (1 if is_add else 0), 0
        if syscall_id == SyscallCode.KECCAK_SPONGE:
            # absorb input (36-u32 / 18-lane blocks) into a zero keccak state,
            # permuting per block; write state[0..8] as 16 u32s to result_ptr
            # (reference: syscalls/precompiles/keccak/sponge.rs — input length
            # in u32s is read from result_ptr + 64, reads at clk, the 16
            # output words written at clk + 1; one extra cycle)
            from .keccak import keccakf

            input_ptr, result_ptr = b, c
            ev = {"shard": self.shard, "clk": self.clk, "input_ptr": input_ptr,
                  "result_ptr": result_ptr, "len_read": None, "reads": [],
                  "writes": [], "input": [], "xored_states": []}

            def _rd(addr):
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                tup = (addr, rec[0], rec[1], rec[2])
                rec[1] = self.clk
                rec[2] = self.shard
                return rec[0], tup

            n_u32, len_tup = _rd((result_ptr + 64) & M32)
            ev["len_read"] = len_tup
            assert n_u32 % 36 == 0, "keccak input length not a block multiple"
            words = []
            for i in range(n_u32):
                v, tup = _rd((input_ptr + 4 * i) & M32)
                ev["reads"].append(tup)
                words.append(v)
            ev["input"] = words
            lanes = [
                words[2 * i] | (words[2 * i + 1] << 32)
                for i in range(n_u32 // 2)
            ]
            state = [0] * 25
            for blk in range(n_u32 // 36):
                for i in range(18):
                    state[i] ^= lanes[18 * blk + i]
                ev["xored_states"].append(list(state))
                state = keccakf(state)
            out_words = []
            for i in range(8):
                out_words += [state[i] & M32, (state[i] >> 32) & M32]
            for i in range(16):
                addr = (result_ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["writes"].append((addr, rec[0], rec[1], rec[2], out_words[i]))
                rec[0] = out_words[i]
                rec[1] = self.clk + 1
                rec[2] = self.shard
            self.record.precompile_events.setdefault(
                int(SyscallCode.KECCAK_SPONGE), []
            ).append(ev)
            return syscall_id, None, 1, 0
        if syscall_id == SyscallCode.UINT256_MUL:
            # result = x * y mod m (m == 0 means mod 2^256), written back to
            # x_ptr (reference: syscalls/precompiles/uint256.rs — x read
            # unsafely with no access records, y and modulus are 16 reads at
            # clk, x written at clk + 1; one extra cycle)
            x_ptr, y_ptr = b, c
            assert x_ptr % 4 == 0 and y_ptr % 4 == 0, "uint256 ptr unaligned"
            ev = {"shard": self.shard, "clk": self.clk, "x_ptr": x_ptr,
                  "y_ptr": y_ptr, "reads": [], "writes": []}
            x_words = [self.peek_word((x_ptr + 4 * i) & M32) for i in range(8)]

            def _rd(addr):
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                rec[1] = self.clk
                rec[2] = self.shard
                return rec[0]

            y_words = [_rd((y_ptr + 4 * i) & M32) for i in range(8)]
            m_words = [_rd((y_ptr + 32 + 4 * i) & M32) for i in range(8)]
            to_int = lambda ws: sum(w << (32 * i) for i, w in enumerate(ws))
            x_int, y_int, m_int = to_int(x_words), to_int(y_words), to_int(m_words)
            r_int = (x_int * y_int) % (m_int if m_int else (1 << 256))
            for i in range(8):
                addr = (x_ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                rv = (r_int >> (32 * i)) & M32
                ev["writes"].append((addr, rec[0], rec[1], rec[2], rv))
                rec[0] = rv
                rec[1] = self.clk + 1
                rec[2] = self.shard
            self.record.precompile_events.setdefault(
                int(SyscallCode.UINT256_MUL), []
            ).append(ev)
            return syscall_id, None, 1, 0
        if syscall_id == SyscallCode.SHA_EXTEND:
            # w[i] = w[i-16] + s0(w[i-15]) + w[i-7] + s1(w[i-2]), i = 16..63
            # one event per iteration at clk + (i - 16); 48 extra cycles
            ptr = b
            assert ptr % 4 == 0, "sha_extend state must be word-aligned"
            evs = self.record.precompile_events.setdefault(
                int(SyscallCode.SHA_EXTEND), []
            )
            ror = lambda x, r: ((x >> r) | (x << (32 - r))) & M32
            for i in range(16, 64):
                clk_i = self.clk + (i - 16)
                ev = {"shard": self.shard, "clk": clk_i, "ptr": ptr, "i": i,
                      "reads": [], "write": None}

                def rd(idx):
                    addr = (ptr + 4 * idx) & M32
                    rec = self.memory.get(addr)
                    if rec is None:
                        rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                        self.memory[addr] = rec
                    self._touch(addr, rec)
                    ev["reads"].append((addr, rec[0], rec[1], rec[2]))
                    v = rec[0]
                    rec[1] = clk_i
                    rec[2] = self.shard
                    return v

                w16 = rd(i - 16)
                w15 = rd(i - 15)
                w7 = rd(i - 7)
                w2 = rd(i - 2)
                s0 = ror(w15, 7) ^ ror(w15, 18) ^ (w15 >> 3)
                s1 = ror(w2, 17) ^ ror(w2, 19) ^ (w2 >> 10)
                out = (w16 + s0 + w7 + s1) & M32
                addr = (ptr + 4 * i) & M32
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                ev["write"] = (addr, rec[0], rec[1], rec[2], out)
                rec[0] = out
                rec[1] = clk_i
                rec[2] = self.shard
                evs.append(ev)
            return syscall_id, None, 48, 0
        if syscall_id == SyscallCode.SHA_COMPRESS:
            # full SHA-256 compression: b = w_ptr (64 words), c = h_ptr (8)
            # h reads + w reads at clk, h writes at clk + 1; 1 extra cycle
            w_ptr, h_ptr = b, c
            assert w_ptr % 4 == 0 and h_ptr % 4 == 0
            ev = {"shard": self.shard, "clk": self.clk, "w_ptr": w_ptr,
                  "h_ptr": h_ptr, "h_reads": [], "w_reads": [], "h_writes": []}

            def _raw_read(addr, ts, out_list):
                rec = self.memory.get(addr)
                if rec is None:
                    rec = [self.uninitialized_memory.get(addr, 0), 0, 0]
                    self.memory[addr] = rec
                self._touch(addr, rec)
                out_list.append((addr, rec[0], rec[1], rec[2]))
                v = rec[0]
                rec[1] = ts
                rec[2] = self.shard
                return v

            hs = [_raw_read((h_ptr + 4 * j) & M32, self.clk, ev["h_reads"])
                  for j in range(8)]
            ws = [_raw_read((w_ptr + 4 * i) & M32, self.clk, ev["w_reads"])
                  for i in range(64)]
            K = _SHA256_K
            a_, b_, c_, d_, e_, f_, g_, h_ = hs
            ror = lambda x, r: ((x >> r) | (x << (32 - r))) & M32
            for i in range(64):
                S1 = ror(e_, 6) ^ ror(e_, 11) ^ ror(e_, 25)
                ch = (e_ & f_) ^ ((~e_ & M32) & g_)
                t1 = (h_ + S1 + ch + K[i] + ws[i]) & M32
                S0 = ror(a_, 2) ^ ror(a_, 13) ^ ror(a_, 22)
                maj = (a_ & b_) ^ (a_ & c_) ^ (b_ & c_)
                t2 = (S0 + maj) & M32
                h_, g_, f_, e_, d_, c_, b_, a_ = (
                    g_, f_, e_, (d_ + t1) & M32, c_, b_, a_, (t1 + t2) & M32
                )
            outs = [(x + y) & M32 for x, y in zip(hs, (a_, b_, c_, d_, e_, f_, g_, h_))]
            for j in range(8):
                addr = (h_ptr + 4 * j) & M32
                rec = self.memory[addr]
                ev["h_writes"].append((addr, rec[0], rec[1], rec[2], outs[j]))
                rec[0] = outs[j]
                rec[1] = self.clk + 1
                rec[2] = self.shard
            self.record.precompile_events.setdefault(
                int(SyscallCode.SHA_COMPRESS), []
            ).append(ev)
            return syscall_id, None, 1, 0
        if syscall_id == SyscallCode.SYSHINTLEN:
            if self.input_stream_ptr >= len(self.input_stream):
                raise ExecutionError("no more hints")
            return len(self.input_stream[self.input_stream_ptr]), None, 0, 0
        if syscall_id == SyscallCode.SYSHINTREAD:
            if self.input_stream_ptr >= len(self.input_stream):
                raise ExecutionError("no more hints")
            buf = self.input_stream[self.input_stream_ptr]
            self.input_stream_ptr += 1
            assert len(buf) == c, "hint length mismatch"
            assert b % 4 == 0, "hint read pointer must be word-aligned"
            # the hint becomes the init value at first constrained access
            for i in range(0, len(buf), 4):
                word = int.from_bytes(buf[i : i + 4].ljust(4, b"\x00"), "little")
                addr = (b + i) & M32
                if addr in self.uninitialized_memory or addr in self.memory:
                    raise ExecutionError("hint read address already initialized")
                self.uninitialized_memory[addr] = word
            return c, None, 0, 0
        raise ExecutionError(f"unsupported syscall {syscall_id:#x}")
