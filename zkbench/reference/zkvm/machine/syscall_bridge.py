"""SyscallCore / SyscallPrecompile bridge chips: the two ends of the
GLOBAL syscall multiset that lets precompile events be proven in a
different shard than the one that dispatched them
(reference: crates/core/machine/src/syscall/chip.rs SyscallChip
Core/Precompile instances, crates/stark/src/air/builder.rs
send_syscall/send_syscall_result).

Message plumbing per precompile-class syscall (id has the table-flag byte
set, or is a Linux-family id):

  execution shard:
    SyscallInstrs  --local Syscall [shard,clk,id,arg1,arg2]-->  SyscallCore
    SyscallInstrs  --local SyscallResult (linux only)------->  SyscallCore
    SyscallCore    --Global(Syscall, is_send)------------->  GlobalChip
    SyscallCore    --Global(SyscallResult, is_send)------->  GlobalChip

  shard holding the precompile event (same shard or a deferred one):
    SyscallPrecompile  <--Global(Syscall, is_receive)----  GlobalChip
    SyscallPrecompile  <--Global(SyscallResult, is_receive)  GlobalChip
    SyscallPrecompile  --local Syscall---------------->  precompile chip
    SyscallPrecompile  --local SyscallResult (linux)--->  SysLinux chip

The global messages use half-word packed arguments (collision-free: each
half is U16-range-checked, so the 7-limb tuple injectively encodes the
32-bit values — reference chip.rs "reduce() collisions across shards").

SyscallCore's trace derives from the execution record's CPU columns (the
dispatch rows stay in the execution shard); SyscallPrecompile's trace
derives from the precompile groups attached to whichever record holds the
events (executor/precompile_mem.py)."""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import Opcode
from ..executor.precompile_mem import group_events, is_precompile_sid
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, send_byte
from .layout import Layout, pad_to_pow2

COLS = Layout().add("shard").add("clk").add("syscall_id")
COLS.add("a1_lo").add("a1_hi").add("a2_lo").add("a2_hi")
COLS.add("r_lo").add("r_hi")
COLS.add("is_linux")
COLS.add("is_real")


def _halves(v: int) -> tuple[int, int]:
    return v & 0xFFFF, (v >> 16) & 0xFFFF


def _is_linux_sid(sid: int) -> bool:
    return 4000 <= sid < 4300


def core_dispatches(record):
    """(shard, clk, sid, arg1, arg2, result) per precompile-class dispatch
    row of the execution record, in cycle order (cached)."""
    cached = getattr(record, "_core_dispatches", None)
    if cached is not None:
        return cached
    out = []
    cols = record.freeze()
    if len(cols["clk"]):
        instrs = record.program.instructions
        ops = np.array([int(instrs[i].opcode) for i in cols["instr_idx"]],
                       dtype=np.int64)
        mask = ops == int(Opcode.SYSCALL)
        shard = record.public_values.shard
        for clk, sid, b, c, a in zip(
            cols["clk"][mask], cols["prev_a"][mask], cols["b"][mask],
            cols["c"][mask], cols["a"][mask]
        ):
            if is_precompile_sid(int(sid)):
                sid = int(sid)
                out.append((shard, int(clk), sid, int(b), int(c), int(a)))
    record._core_dispatches = out
    return out


def _rows_from(entries):
    """entries: (shard, clk, sid, arg1, arg2, result) -> trace writer rows."""
    n = len(entries)
    w = COLS.writer(n)
    for i, (shard, clk, sid, a1, a2, res) in enumerate(entries):
        linux = _is_linux_sid(sid)
        w.mat[i, COLS.idx("shard")] = shard
        w.mat[i, COLS.idx("clk")] = clk
        w.mat[i, COLS.idx("syscall_id")] = sid
        lo, hi = _halves(a1)
        w.mat[i, COLS.idx("a1_lo")], w.mat[i, COLS.idx("a1_hi")] = lo, hi
        lo, hi = _halves(a2)
        w.mat[i, COLS.idx("a2_lo")], w.mat[i, COLS.idx("a2_hi")] = lo, hi
        if linux:
            lo, hi = _halves(res)
            w.mat[i, COLS.idx("r_lo")], w.mat[i, COLS.idx("r_hi")] = lo, hi
        w.mat[i, COLS.idx("is_linux")] = int(linux)
        w.mat[i, COLS.idx("is_real")] = 1
    return pad_to_pow2(w.mat)


def _count_deps(record, entries):
    for _, _, _, a1, a2, _ in entries:
        for v in (*_halves(a1), *_halves(a2)):
            count(record, B.U16Range, np.array([v]), 0)


def global_syscall_events(record) -> list:
    """The (message7, is_send, kind) entries this record's bridge chips put
    on the global multiset — consumed by the GlobalChip's trace."""
    events = []
    for shard, clk, sid, a1, a2, res in core_dispatches(record):
        a1l, a1h = _halves(a1)
        a2l, a2h = _halves(a2)
        rl, rh = _halves(res) if _is_linux_sid(sid) else (0, 0)
        events.append(([shard, clk, sid, a1l, a1h, a2l, a2h], 1,
                       int(LookupKind.Syscall)))
        events.append(([shard, clk, sid, rl, rh, 0, 0], 1,
                       int(LookupKind.SyscallResult)))
    for g in group_events(record):
        a1l, a1h = _halves(g["arg1"])
        a2l, a2h = _halves(g["arg2"])
        linux = _is_linux_sid(g["sid"])
        rl, rh = _halves(g["result"]) if linux else (0, 0)
        events.append(([g["shard"], g["clk"], g["sid"], a1l, a1h, a2l, a2h],
                       0, int(LookupKind.Syscall)))
        events.append(([g["shard"], g["clk"], g["sid"], rl, rh, 0, 0], 0,
                       int(LookupKind.SyscallResult)))
    return events


class _BridgeBase(Air):
    # pure multiset bridging: dispatch tuple is free witness
    picus_inputs = ("shard", "clk", "syscall_id", "a1_lo", "a1_hi",
                    "a2_lo", "a2_hi", "is_linux", "is_real")
    picus_outputs = ("r_lo", "r_hi")
    width = COLS.width

    def _eval_common(self, b):
        L = COLS.view(b.main_local)
        is_real = L["is_real"]
        is_linux = L["is_linux"]
        b.assert_bool(is_real)
        b.assert_bool(is_linux)
        b.when(1 - is_real).assert_zero(is_linux)
        # result halves are zero unless linux, so the global SyscallResult
        # message is well-defined at degree 1
        b.when(1 - is_linux).assert_zero(L["r_lo"])
        b.when(1 - is_linux).assert_zero(L["r_hi"])
        for nm in ("a1_lo", "a1_hi", "a2_lo", "a2_hi"):
            send_byte(b, B.U16Range, L[nm], 0, 0, is_real)
        return L

    @staticmethod
    def _messages(L):
        arg1 = L["a1_lo"] + L["a1_hi"] * 65536
        arg2 = L["a2_lo"] + L["a2_hi"] * 65536
        syscall = [L["shard"], L["clk"], L["syscall_id"], arg1, arg2]
        result = [L["shard"], L["clk"], L["r_lo"], L["r_hi"],
                  L["a1_lo"], L["a1_hi"], L["a2_lo"], L["a2_hi"]]
        gsys = [L["shard"], L["clk"], L["syscall_id"],
                L["a1_lo"], L["a1_hi"], L["a2_lo"], L["a2_hi"]]
        gres = [L["shard"], L["clk"], L["syscall_id"], L["r_lo"], L["r_hi"],
                0, 0]
        return syscall, result, gsys, gres


class SyscallCoreChip(_BridgeBase):
    name = "SyscallCore"
    cycle_chip = True  # rows come from this shard's execution cycles

    def included(self, record):
        return bool(core_dispatches(record))

    def num_rows(self, record):
        return len(core_dispatches(record))

    def generate_dependencies(self, record, output):
        _count_deps(record, core_dispatches(record))

    def generate_trace(self, record, output):
        return _rows_from(core_dispatches(record))

    def eval(self, b):
        L = self._eval_common(b)
        syscall, result, gsys, gres = self._messages(L)
        is_real, is_linux = L["is_real"], L["is_linux"]
        b.receive(LookupKind.Syscall, syscall, is_real)
        b.receive(LookupKind.SyscallResult, result, is_linux)
        b.send(LookupKind.Global,
               gsys + [is_real, 0, int(LookupKind.Syscall)], is_real)
        b.send(LookupKind.Global,
               gres + [is_real, 0, int(LookupKind.SyscallResult)], is_real)


def precompile_entries(record):
    groups = group_events(record)
    return [(g["shard"], g["clk"], g["sid"], g["arg1"], g["arg2"],
             g["result"]) for g in groups]


class SyscallPrecompileChip(_BridgeBase):
    name = "SyscallPrecompile"

    def included(self, record):
        return bool(group_events(record))

    def num_rows(self, record):
        return len(group_events(record))

    def generate_dependencies(self, record, output):
        _count_deps(record, precompile_entries(record))

    def generate_trace(self, record, output):
        return _rows_from(precompile_entries(record))

    def eval(self, b):
        L = self._eval_common(b)
        syscall, result, gsys, gres = self._messages(L)
        is_real, is_linux = L["is_real"], L["is_linux"]
        b.send(LookupKind.Syscall, syscall, is_real)
        b.send(LookupKind.SyscallResult, result, is_linux)
        b.send(LookupKind.Global,
               gsys + [0, is_real, int(LookupKind.Syscall)], is_real)
        b.send(LookupKind.Global,
               gres + [0, is_real, int(LookupKind.SyscallResult)], is_real)
