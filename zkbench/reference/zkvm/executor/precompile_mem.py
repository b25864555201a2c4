"""Precompile event scoping: per-syscall local memory segments + canonical
dispatch arguments — the executor-side half of precompile deferred-event
splitting (reference: crates/core/executor/src/syscalls/context.rs
postprocess() per-syscall MemoryLocalEvents, record.rs:115-130 defer/split,
crates/core/machine/src/syscall/chip.rs SyscallChip Core/Precompile).

Design (TPU-first, shared across the python and native executors): instead
of maintaining per-syscall local-memory maps inside both executors' hot
loops, this module derives them POST-HOC from what the event streams
already record:

  * every precompile event stores each access's previous tuple
    (prev_shard, prev_clk, prev_value) — the executor's page-table state
    before the access — plus the written value;
  * each family's access *timestamp convention* (reads at clk, writes at
    clk or clk+1) is exactly the convention its AIR chip constrains, and is
    declared once in MEM_SPEC below;
  * a shard's single first→last span per address (executor shard_initial /
    shard_final) is then TILED into alternating CPU segments and
    precompile scopes. The tiling is fully determined and self-checking:
    scope boundaries must chain exactly (each scope's initial tuple equals
    the previous segment's final tuple), so a wrong convention fails loudly
    rather than producing an unbalanced multiset.

The resulting `record.local_segments` (one row per segment in the
MemoryLocal chip) and per-group `local_mem` (the segments that travel WITH
a deferred precompile group) make every memory handoff that crosses a
scope go through the GLOBAL septic multiset, which is what lets precompile
events be proven in a different shard than the one that executed them.

Groups: one group per syscall dispatch (sha_extend's 48 per-iteration
events form one group). A group also carries the canonical dispatch
arguments (arg1 = op_b, arg2 = op_c, result = op_a) read from the CPU
columns of the originating record — the values the SyscallCore /
SyscallPrecompile bridge chips put on the global syscall multiset.
"""

from __future__ import annotations

import numpy as np

from .opcode import Opcode, SyscallCode

# ---------------------------------------------------------------------------
# family access conventions: sid -> list of (event key, ts offset, is_write,
# is_list). Order = temporal order of the accesses inside one event.
# These mirror the ts arguments each chip passes to fill_access/eval_access.
# ---------------------------------------------------------------------------

_FPOPS = [
    SyscallCode.BLS12381_FP_ADD, SyscallCode.BLS12381_FP_SUB,
    SyscallCode.BLS12381_FP_MUL, SyscallCode.BLS12381_FP2_ADD,
    SyscallCode.BLS12381_FP2_SUB, SyscallCode.BLS12381_FP2_MUL,
    SyscallCode.BN254_FP_ADD, SyscallCode.BN254_FP_SUB,
    SyscallCode.BN254_FP_MUL, SyscallCode.BN254_FP2_ADD,
    SyscallCode.BN254_FP2_SUB, SyscallCode.BN254_FP2_MUL,
]

RW_01 = [("reads", 0, False, True), ("writes", 1, True, True)]
RW_00 = [("reads", 0, False, True), ("writes", 0, True, True)]

MEM_SPEC: dict[int, list] = {
    int(SyscallCode.POSEIDON2_PERMUTE): RW_01,
    int(SyscallCode.BOOLEAN_CIRCUIT_GARBLE): RW_00,
    int(SyscallCode.SYS_LINUX): RW_00,
    int(SyscallCode.U256XU2048_MUL): RW_01,
    int(SyscallCode.ED_ADD): RW_01,
    int(SyscallCode.ED_DECOMPRESS): RW_00,
    int(SyscallCode.UINT256_MUL): RW_01,
    int(SyscallCode.SHA_EXTEND): [("reads", 0, False, True),
                                  ("write", 0, True, False)],
    int(SyscallCode.SHA_COMPRESS): [("h_reads", 0, False, True),
                                    ("w_reads", 0, False, True),
                                    ("h_writes", 1, True, True)],
    int(SyscallCode.KECCAK_SPONGE): [("len_read", 0, False, False),
                                     ("reads", 0, False, True),
                                     ("writes", 1, True, True)],
    # weierstrass add/double/decompress (per-curve codes filled below)
}
for c in _FPOPS:
    MEM_SPEC[int(c)] = RW_01
for c in (SyscallCode.SECP256K1_ADD, SyscallCode.SECP256R1_ADD,
          SyscallCode.BN254_ADD, SyscallCode.BLS12381_ADD):
    MEM_SPEC[int(c)] = RW_01
for c in (SyscallCode.SECP256K1_DOUBLE, SyscallCode.SECP256R1_DOUBLE,
          SyscallCode.BN254_DOUBLE):
    MEM_SPEC[int(c)] = RW_00
for c in (SyscallCode.BLS12381_DOUBLE,):
    MEM_SPEC[int(c)] = RW_00
for c in (SyscallCode.SECP256K1_DECOMPRESS, SyscallCode.SECP256R1_DECOMPRESS,
          SyscallCode.BLS12381_DECOMPRESS):
    MEM_SPEC[int(c)] = RW_00


def is_precompile_sid(sid: int) -> bool:
    """Precompile-class syscalls: table flag byte set, or the Linux family
    (reference: SyscallChip Core included() — prev_value bytes[2] == 1 or
    bytes[1] != 0)."""
    return ((sid >> 16) & 0xFF) == 1 or 4000 <= sid < 4300


def event_accesses(sid: int, ev: dict):
    """Yield (addr, prev_shard, prev_clk, prev_value, value, ts) in temporal
    order for one event. Read tuples: (addr, value, prev_clk, prev_shard);
    write tuples: (addr, prev_value, prev_clk, prev_shard, value)."""
    spec = MEM_SPEC[sid]
    clk = ev["clk"]
    for key, off, is_write, is_list in spec:
        items = ev.get(key)
        if items is None:
            continue
        if not is_list:
            items = [items]
        for t in items:
            if is_write:
                addr, prev_v, prev_clk, prev_sh, value = (
                    t[0], t[1], t[2], t[3], t[4])
            else:
                addr, prev_v, prev_clk, prev_sh = t[0], t[1], t[2], t[3]
                value = prev_v
            yield (int(addr), int(prev_sh), int(prev_clk), int(prev_v),
                   int(value), int(clk) + off)


def group_events(record) -> list[dict]:
    """One group per syscall dispatch. Returns (and caches on the record)
    [{sid, shard, clk, events, local_mem, arg1, arg2, result}].
    local_mem: sorted [(addr, (ish,iclk,ival), (fsh,fclk,fval))] — this
    group's memory scope endpoints."""
    cached = getattr(record, "precompile_groups", None)
    if cached is not None:
        return cached
    groups: list[dict] = []
    for sid, evs in sorted(record.precompile_events.items()):
        if not is_precompile_sid(sid) or not evs:
            continue
        if sid == int(SyscallCode.SHA_EXTEND):
            assert len(evs) % 48 == 0, "sha_extend events not in 48-groups"
            chunks = [evs[i:i + 48] for i in range(0, len(evs), 48)]
        else:
            chunks = [[ev] for ev in evs]
        for chunk in chunks:
            # Linux events are stored under the SYS_LINUX family key; the
            # canonical syscall id on the multiset is the ACTUAL Linux id
            actual = int(chunk[0].get("syscall_code", sid))
            g = {
                "sid": actual,
                "store_sid": int(sid),
                "shard": int(chunk[0]["shard"]),
                "clk": int(chunk[0]["clk"]),
                "events": chunk,
                "local_mem": _scope_endpoints(sid, chunk),
            }
            groups.append(g)
    _attach_args(record, groups)
    record.precompile_groups = groups
    return groups


def _scope_endpoints(sid, events) -> list:
    """Per-address (initial, final) over all accesses of the group."""
    first: dict[int, tuple] = {}
    last: dict[int, tuple] = {}
    shard = int(events[0]["shard"])
    for ev in events:
        for addr, psh, pclk, pval, val, ts in event_accesses(sid, ev):
            if addr not in first:
                first[addr] = (psh, pclk, pval)
            cur = last.get(addr)
            if cur is None or (ts, 1) >= (cur[1], 1):
                # accesses to the same addr strictly advance ts within a
                # group except read-then-write at the same ts (garble /
                # linux style): later-listed access wins
                last[addr] = (shard, ts, val)
    return sorted(
        (addr, first[addr], last[addr]) for addr in first
    )


def _attach_args(record, groups) -> None:
    """Canonical dispatch args from the originating record's CPU columns:
    arg1 = op_b, arg2 = op_c, result = op_a at the dispatch cycle. Must run
    BEFORE deferral moves the groups away from their execution record."""
    if not groups:
        return
    cols = record.freeze()
    if not len(cols["clk"]):
        raise AssertionError("precompile events in a record with no cycles")
    ops = record.program and [
        int(i.opcode) for i in record.program.instructions
    ]
    idx = cols["instr_idx"]
    mask = np.array([ops[i] == int(Opcode.SYSCALL) for i in idx], dtype=bool)
    clks = cols["clk"][mask]
    args = {}
    for clk, b, c, a in zip(clks, cols["b"][mask], cols["c"][mask],
                            cols["a"][mask]):
        args[int(clk)] = (int(b), int(c), int(a))
    for g in groups:
        b, c, a = args[g["clk"]]
        g["arg1"], g["arg2"], g["result"] = b, c, a
        for ev in g["events"]:  # single-arg chips need arg2 in their trace
            ev["_arg1"], ev["_arg2"] = b, c


_STAMP = lambda t: (t[0], t[1])  # (shard, clk) ordering of a tuple


def compute_local_segments(record) -> list:
    """Tile each address's shard-wide span into CPU segments by cutting out
    the precompile scopes. Sets and returns `record.local_segments`
    (the MemoryLocal rows owned by the EXECUTION side of this record;
    precompile scopes travel with their groups). Self-checking: scope
    chains must tile exactly."""
    cached = getattr(record, "local_segments", None)
    if cached is not None:
        return cached
    groups = group_events(record)
    scopes_by_addr: dict[int, list] = {}
    for g in groups:
        for addr, init, fin in g["local_mem"]:
            scopes_by_addr.setdefault(addr, []).append((init, fin))
    segments = []
    for addr in sorted(record.shard_initial):
        init0 = tuple(record.shard_initial[addr])
        final0 = tuple(record.shard_final[addr])
        scopes = sorted(scopes_by_addr.get(addr, []),
                        key=lambda s: _STAMP(s[0]))
        cur = init0
        for s_init, s_fin in scopes:
            s_init, s_fin = tuple(s_init), tuple(s_fin)
            if s_init != cur:
                assert _STAMP(s_init) > _STAMP(cur), (
                    f"scope tiling broken at addr {addr:#x}: "
                    f"cur={cur} scope_init={s_init}")
                segments.append((addr, cur, s_init))
            cur = s_fin
        if cur != final0:
            assert _STAMP(final0) > _STAMP(cur), (
                f"span end mismatch at addr {addr:#x}: cur={cur} "
                f"final={final0}")
            segments.append((addr, cur, final0))
    record.local_segments = segments
    return segments
