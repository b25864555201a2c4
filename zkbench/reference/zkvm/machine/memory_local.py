"""MemoryLocalChip: per-shard memory access endpoints
(reference: crates/core/machine/src/memory/local.rs).

For every address touched in the shard it receives the first access's
previous tuple and sends the last tuple — balancing the shard's Local memory
multiset — and routes both tuples into the Global multiset (received by the
GlobalChip, accumulated onto the septic curve): the initial tuple as a
global *receive*, the final tuple as a global *send*, so consecutive shards
telescope and the MemoryInit/Final chips provide the overall endpoints.
"""

from __future__ import annotations

import numpy as np

from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .layout import Layout, pad_to_pow2, word_decompose_np

COLS = Layout().add("addr")
COLS.add("init_shard").add("init_clk").word("init_value")
COLS.add("final_shard").add("final_clk").word("final_value")
COLS.add("is_real")


def global_memory_message(shard, clk, addr, value_word):
    return [shard, clk, addr] + list(value_word)


def all_local_segments(record) -> list:
    """Every local-memory segment this record owns: the execution side's
    CPU segments (the shard's per-address spans, tiled around precompile
    scopes — executor/precompile_mem.py) plus the scopes of every
    precompile group attached to this record (in place or deferred).
    Each item: (addr, (init_shard, init_clk, init_value),
    (final_shard, final_clk, final_value))."""
    from ..executor.precompile_mem import (
        compute_local_segments,
        group_events,
    )

    segments = list(compute_local_segments(record))
    for g in group_events(record):
        segments.extend(g["local_mem"])
    return segments


class MemoryLocalChip(Air):
    # pure multiset routing: every column is a free endpoint tuple
    picus_inputs = ("addr", "init_shard", "init_clk", "init_value",
                    "final_shard", "final_clk", "final_value", "is_real")
    picus_outputs = ()
    name = "MemoryLocal"
    width = COLS.width

    def num_rows(self, record):
        return len(all_local_segments(record))

    def generate_trace(self, record, output):
        segs = all_local_segments(record)
        n = len(segs)
        w = COLS.writer(n)
        w.set("addr", [a for a, _, _ in segs])
        w.set("init_shard", [i[0] for _, i, _ in segs])
        w.set("init_clk", [i[1] for _, i, _ in segs])
        w.set_word("init_value", np.array(
            [i[2] for _, i, _ in segs], dtype=np.int64))
        w.set("final_shard", [f[0] for _, _, f in segs])
        w.set("final_clk", [f[1] for _, _, f in segs])
        w.set_word("final_value", np.array(
            [f[2] for _, _, f in segs], dtype=np.int64))
        w.set("is_real", np.ones(n))
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        init = [L["init_shard"], L["init_clk"], L["addr"]] + list(L.word("init_value"))
        final = [L["final_shard"], L["final_clk"], L["addr"]] + list(
            L.word("final_value")
        )
        # balance the shard-local memory multiset
        b.receive(LookupKind.Memory, init, is_real)
        b.send(LookupKind.Memory, final, is_real)
        # route the endpoints into the global multiset (GlobalChip)
        b.send(
            LookupKind.Global,
            init + [0, is_real, int(LookupKind.Memory)],  # is_send=0, is_receive=1
            is_real,
        )
        b.send(
            LookupKind.Global,
            final + [is_real, 0, int(LookupKind.Memory)],  # is_send=1
            is_real,
        )
