"""Execution records and public values.

The CPU event stream is **columnar from the start** (SoA numpy arrays), so
chip trace generation is pure vectorized selection/projection — the
TPU-first redesign of the reference's per-chip event vectors
(reference: crates/core/executor/src/record.rs, events/).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

PROOF_MAX_NUM_PVS = 231  # reference: crates/stark/src/types.rs:73
PV_DIGEST_NUM_WORDS = 8
POSEIDON_NUM_WORDS = 8


@dataclass
class PublicValues:
    """(reference: crates/stark/src/air/public_values.rs:22-60)"""

    committed_value_digest: list = field(default_factory=lambda: [0] * 8)  # 8 words
    deferred_proofs_digest: list = field(default_factory=lambda: [0] * 8)
    start_pc: int = 0
    next_pc: int = 0
    exit_code: int = 0
    shard: int = 0
    execution_shard: int = 0
    previous_init_addr_bits: list = field(default_factory=lambda: [0] * 32)
    last_init_addr_bits: list = field(default_factory=lambda: [0] * 32)
    previous_finalize_addr_bits: list = field(default_factory=lambda: [0] * 32)
    last_finalize_addr_bits: list = field(default_factory=lambda: [0] * 32)

    def to_list(self) -> list:
        out = []
        for w in self.committed_value_digest:  # each word as 4 byte-felts
            out.extend([(w >> (8 * i)) & 0xFF for i in range(4)])
        out.extend(self.deferred_proofs_digest)
        out.extend(
            [self.start_pc, self.next_pc, self.exit_code, self.shard, self.execution_shard]
        )
        out.extend(self.previous_init_addr_bits)
        out.extend(self.last_init_addr_bits)
        out.extend(self.previous_finalize_addr_bits)
        out.extend(self.last_finalize_addr_bits)
        out.extend([0, 0, 0])  # padding ("empty")
        out.extend([0] * (PROOF_MAX_NUM_PVS - len(out)))
        return out


# columnar CPU event fields; every access position has (active, addr,
# prev_value, prev_clk, value); `clk` is the cycle base timestamp (+5/cycle)
CPU_FIELDS = [
    "clk",
    "pc",
    "next_pc",
    "next_next_pc",
    "instr_idx",
    "a",
    "b",
    "c",
    "prev_a",
    "exit_code",
    "syscall_code",
]
POSITIONS = ["mem", "c", "b", "a", "hi"]  # timestamp offsets 0..4
POS_FIELDS = ["act", "addr", "prev_value", "prev_clk", "prev_shard", "value", "is_write"]


class ExecutionRecord:
    def __init__(self, program):
        self.program = program
        self.public_values = PublicValues()
        self.columns: dict[str, list] = {f: [] for f in CPU_FIELDS}
        for p in POSITIONS:
            for f in POS_FIELDS:
                self.columns[f"{p}_{f}"] = []
        self.mem_init: list = []  # (addr, value) at first touch
        self.mem_final: list = []  # (addr, clk, value) at shard end
        self.byte_counts: dict = {}  # (op, b, c) -> multiplicity
        self.synthetic: dict = {}  # opcode -> [(a, b, c, hi)] sub-operations
        # precompile events: syscall id -> list of event dicts (columnar-ready)
        self.precompile_events: dict = {}
        # per-shard memory endpoints (MemoryLocal chip):
        # addr -> (shard, clk, value) at shard entry / exit
        self.shard_initial: dict = {}
        self.shard_final: dict = {}
        # (vkey digest, pv digest) claims from VERIFY_ZKM_PROOF; folded into
        # pv.deferred_proofs_digest by the recursion layer
        self.deferred_proof_claims: list = []
        self._frozen = None

    def append_cycle(self, **fields):
        for f in CPU_FIELDS:
            self.columns[f].append(fields.get(f, 0))
        accesses = fields.get("accesses", {})
        for p in POSITIONS:
            rec = accesses.get(p)
            if rec is None:
                for f in POS_FIELDS:
                    self.columns[f"{p}_{f}"].append(0)
            else:
                addr, prev_value, prev_clk, prev_shard, value, is_write = rec
                self.columns[f"{p}_act"].append(1)
                self.columns[f"{p}_addr"].append(addr)
                self.columns[f"{p}_prev_value"].append(prev_value)
                self.columns[f"{p}_prev_clk"].append(prev_clk)
                self.columns[f"{p}_prev_shard"].append(prev_shard)
                self.columns[f"{p}_value"].append(value)
                self.columns[f"{p}_is_write"].append(int(is_write))

    def freeze(self) -> dict:
        """Convert columnar lists to numpy arrays (cached)."""
        if self._frozen is None:
            self._frozen = {
                k: np.asarray(v, dtype=np.int64) for k, v in self.columns.items()
            }
        return self._frozen

    @property
    def num_cycles(self) -> int:
        if self._frozen is not None:
            return len(self._frozen["clk"])
        return len(self.columns["clk"])

    def add_byte_lookup(self, op: int, b: int, c: int, mult: int = 1):
        key = (op, b, c)
        self.byte_counts[key] = self.byte_counts.get(key, 0) + mult
