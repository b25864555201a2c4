"""Deferred-event splitting: distributed memory init/finalize shards
(reference: crates/core/executor/src/record.rs:115-130 defer/split,
crates/stark/src/opts.rs:237-257 SplitOpts,
crates/core/machine/src/memory/global.rs first/last-row address chaining,
crates/stark/src/air/public_values.rs:22-60).

The memory init/finalize multisets cover EVERY address the execution
touched — for large guests they dwarf a single shard. The reference moves
them out of the execution shards into standalone "memory shards" at the
end of the proof, each holding a bounded, address-sorted chunk; soundness
of the global ordering (no address initialized or finalized twice) is
carried across shards by four PublicValues fields:

    previous_init_addr_bits / last_init_addr_bits
    previous_finalize_addr_bits / last_finalize_addr_bits

each a 32-bit little-endian decomposition of an address. Within a shard
the MemoryInit/MemoryFinal chips constrain: first real row's address is
strictly greater than `previous_*` (unless previous == 0, the
zero-address bootstrap case), addresses strictly increase row to row, and
the last real row's address equals `last_*`. Across shards the host
verifier (machine/mips.py verify_mips_proof) and the recursion layer
(recursion/mips_pipeline.py lift/join) chain last -> previous.

This module is the host-side `split()`: it runs after execution (both the
python and native executors put the full init/finalize sets in the last
record) and either leaves them there (small workloads — the reference's
`combine_memory_threshold`) or moves them into standalone memory records.
Memory records contain no cycles: the cycle-driven chips exclude
themselves (`Air.cycle_chip`), so a memory shard proves only
{Program, Byte, MemoryInit, MemoryFinal, Global}.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .record import ExecutionRecord


@dataclass
class SplitOpts:
    """Deferred-event thresholds (reference opts.rs:237-257).

    memory: max init/finalize events per standalone memory shard.
    combine_memory_threshold: if the total touched-address count is at or
    below this, init/finalize stay combined in the last execution shard
    (one fewer proof for small guests)."""

    memory: int = 1 << 16
    combine_memory_threshold: int = 1 << 14
    # precompile deferral threshold, in TRACE ROWS per family per shard
    # (reference opts.rs:237-269 SplitOpts::new derives per-family event
    # thresholds from one knob; here the per-family row weights live in
    # `group_rows` so a single row budget bounds every precompile chip's
    # height)
    deferred: int = 1 << 15

    @staticmethod
    def from_env() -> "SplitOpts":
        """RAM-tiered defaults + env overrides via the central options
        (stark/opts.py ZirenCoreOpts.auto, reference ZKMCoreOpts)."""
        from ..stark.opts import ZirenCoreOpts

        s = ZirenCoreOpts.auto().split_opts
        return SplitOpts(
            memory=s.memory,
            combine_memory_threshold=s.combine_memory_threshold,
            deferred=s.deferred,
        )


def addr_bits(addr: int) -> list:
    """32-bit little-endian decomposition (the pv field encoding)."""
    return [(int(addr) >> i) & 1 for i in range(32)]


def ensure_zero_address(record) -> None:
    """Guarantee the init/finalize sets start at address 0 (register $zero,
    value 0). The MemoryInit/Final AIRs anchor the address chain at zero:
    when the `previous_*` pv is zero the first row must BE address 0
    (reference global.rs:397-421), so the bootstrap endpoint must always
    exist. Untouched address 0 contributes cancelling init/finalize global
    multiset entries (identical tuples, send vs receive)."""
    if record.mem_init and record.mem_init[0][0] == 0:
        return
    assert not record.mem_init or record.mem_init[0][0] > 0
    record.mem_init.insert(0, (0, 0))
    record.mem_final.insert(0, (0, 0, 0, 0))


def set_last_memory_bits(record) -> None:
    """Populate last_init/finalize_addr_bits for a record that carries
    memory endpoints (previous_* stay as already set)."""
    pv = record.public_values
    if record.mem_init:
        pv.last_init_addr_bits = addr_bits(record.mem_init[-1][0])
    else:
        pv.last_init_addr_bits = list(pv.previous_init_addr_bits)
    if record.mem_final:
        pv.last_finalize_addr_bits = addr_bits(record.mem_final[-1][0])
    else:
        pv.last_finalize_addr_bits = list(pv.previous_finalize_addr_bits)


def group_rows(g: dict) -> int:
    """Trace rows a precompile group contributes to its family's chip."""
    from .opcode import SyscallCode as S

    sid = g["store_sid"]
    if sid == int(S.SHA_EXTEND):
        return 48
    if sid == int(S.SHA_COMPRESS):
        return 80
    if sid == int(S.KECCAK_SPONGE):
        return 24 * max(1, len(g["events"][0].get("xored_states", [1])))
    if sid == int(S.BOOLEAN_CIRCUIT_GARBLE):
        return max(1, int(g["events"][0]["reads"][0][1]))  # gate count
    return 1


def finalize_precompiles(records: list, opts: SplitOpts) -> list:
    """The precompile half of deferred-event splitting (reference
    record.rs:130 split(), syscall/chip.rs Core/Precompile). For each
    family whose trace rows in some execution shard exceed
    `opts.deferred`, move that shard's groups into standalone precompile
    shards (chunked to the row budget). Cross-shard soundness rides the
    GLOBAL syscall multiset: the origin shard's SyscallCore rows (which
    derive from its CPU columns and do NOT move) send each dispatch onto
    the septic curve; the deferred shard's SyscallPrecompile rows receive
    them. Returns the standalone records (pv fields are filled by the
    caller, finalize_memory)."""
    from .precompile_mem import compute_local_segments, group_events
    from .record import ExecutionRecord

    moved: list = []  # groups, in (record, group) order
    for rec in records:
        groups = group_events(rec)
        # CPU segments must be tiled against ALL scopes before any move
        compute_local_segments(rec)
        if not groups:
            continue
        rows_by_family: dict[int, int] = {}
        for g in groups:
            rows_by_family[g["store_sid"]] = (
                rows_by_family.get(g["store_sid"], 0) + group_rows(g)
            )
        heavy = {sid for sid, n in rows_by_family.items()
                 if n > opts.deferred}
        if not heavy:
            continue
        keep = [g for g in groups if g["store_sid"] not in heavy]
        moved.extend(g for g in groups if g["store_sid"] in heavy)
        rec.precompile_groups = keep
        for sid in list(rec.precompile_events):
            if sid in heavy:
                del rec.precompile_events[sid]
        # core dispatch rows stay: they derive from the CPU columns, not
        # from the events — that end of the global multiset doesn't move

    if not moved:
        return []
    out = []
    program = records[0].program
    chunk: list = []
    chunk_rows = 0
    for g in moved:
        r = group_rows(g)
        if chunk and chunk_rows + r > opts.deferred:
            out.append((chunk, chunk_rows))
            chunk, chunk_rows = [], 0
        chunk.append(g)
        chunk_rows += r
    if chunk:
        out.append((chunk, chunk_rows))
    shards = []
    for groups, _rows in out:
        rec = ExecutionRecord(program)
        rec.precompile_groups = groups
        rec.local_segments = []
        for g in groups:
            rec.precompile_events.setdefault(
                g["store_sid"], []).extend(g["events"])
        shards.append(rec)
    return shards


def finalize_memory(records: list, opts: SplitOpts | None = None) -> list:
    """Post-execution split pass. `records` is the executor's shard list
    with the full init/finalize sets in the LAST record (address-sorted).
    Returns the final record list: execution shards (+ standalone memory
    shards when the sets exceed the combine threshold), with all four
    addr-bits pv fields populated and shard numbering extended."""
    opts = opts or SplitOpts.from_env()
    pre_shards = finalize_precompiles(records, opts)

    def _deferred_pv(rec, pv_last, shard_no, n_exec, bits_i, bits_f):
        """Post-halt deferred shard: pc frozen, digests copied, addr-bit
        chain pass-through."""
        pv = rec.public_values
        pv.start_pc = pv_last.next_pc
        pv.next_pc = pv_last.next_pc
        pv.exit_code = pv_last.exit_code
        pv.committed_value_digest = list(pv_last.committed_value_digest)
        pv.deferred_proofs_digest = list(pv_last.deferred_proofs_digest)
        pv.shard = shard_no
        pv.execution_shard = n_exec + 1
        pv.previous_init_addr_bits = list(bits_i)
        pv.last_init_addr_bits = list(bits_i)
        pv.previous_finalize_addr_bits = list(bits_f)
        pv.last_finalize_addr_bits = list(bits_f)

    last = records[-1]
    ensure_zero_address(last)
    init = last.mem_init
    final = last.mem_final
    assert all(init[i][0] < init[i + 1][0] for i in range(len(init) - 1)), \
        "init events not address-sorted"
    assert all(final[i][0] < final[i + 1][0] for i in range(len(final) - 1)), \
        "finalize events not address-sorted"

    if len(init) <= opts.combine_memory_threshold and len(
        final
    ) <= opts.combine_memory_threshold:
        set_last_memory_bits(last)
        n_exec = len(records)
        out = list(records)
        pv_last = last.public_values
        for k, rec in enumerate(pre_shards):
            _deferred_pv(rec, pv_last, n_exec + 1 + k, n_exec,
                         pv_last.last_init_addr_bits,
                         pv_last.last_finalize_addr_bits)
            out.append(rec)
        return out

    # move init/finalize out of the execution shard entirely; its chain
    # contribution becomes a no-op (last = previous)
    last.mem_init = []
    last.mem_final = []
    set_last_memory_bits(last)
    program = last.program
    pv_last = last.public_values
    n_exec = len(records)

    out = list(records)
    # standalone precompile shards first (chain no-ops), then memory shards
    for k, rec in enumerate(pre_shards):
        _deferred_pv(rec, pv_last, n_exec + 1 + k, n_exec,
                     pv_last.last_init_addr_bits,
                     pv_last.last_finalize_addr_bits)
        out.append(rec)
    base = n_exec + len(pre_shards)
    prev_init = list(pv_last.last_init_addr_bits)
    prev_fin = list(pv_last.last_finalize_addr_bits)
    k = 0
    m = opts.memory
    while k * m < max(len(init), len(final)):
        rec = ExecutionRecord(program)
        rec.mem_init = init[k * m : (k + 1) * m]
        rec.mem_final = final[k * m : (k + 1) * m]
        pv = rec.public_values
        # post-halt: non-cpu shards carry start_pc == next_pc (== 0 after
        # the halting shard) and the unchanged digests / exit code
        pv.start_pc = pv_last.next_pc
        pv.next_pc = pv_last.next_pc
        pv.exit_code = pv_last.exit_code
        pv.committed_value_digest = list(pv_last.committed_value_digest)
        pv.deferred_proofs_digest = list(pv_last.deferred_proofs_digest)
        pv.shard = base + 1 + k
        # execution shard stays at the post-execution value (non-cpu
        # shards never advance it; reference verify.rs:120-130)
        pv.execution_shard = n_exec + 1
        pv.previous_init_addr_bits = list(prev_init)
        pv.previous_finalize_addr_bits = list(prev_fin)
        set_last_memory_bits(rec)
        prev_init = list(pv.last_init_addr_bits)
        prev_fin = list(pv.last_finalize_addr_bits)
        out.append(rec)
        k += 1
    return out
