"""Shared memory-access columns: offline memory checking with timestamp
comparison (reference: crates/core/machine/src/air/memory.rs,
memory/consistency/columns.rs).

Memory lookup message: [shard, clk, addr, v0, v1, v2, v3].
Each access SENDS the previous tuple and RECEIVES the current one; the
MemoryInit chip receives the init tuple, MemoryFinal sends the final tuple.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..stark.lookup import LookupKind
from .byte import count, send_byte
from .layout import Layout, word_decompose_np

POS_MEMORY, POS_C, POS_B, POS_A, POS_HI = 0, 1, 2, 3, 4


def add_access_cols(layout: Layout, prefix: str, write: bool) -> Layout:
    layout.add(f"{prefix}_prev_shard")
    layout.add(f"{prefix}_prev_clk")
    layout.add(f"{prefix}_compare_clk")
    layout.add(f"{prefix}_d16")
    layout.add(f"{prefix}_d8")
    if write:
        layout.word(f"{prefix}_prev_value")
    layout.word(f"{prefix}_value")
    return layout


def eval_access(b, view, prefix, shard, clk, addr, do_check, write: bool):
    """Constraint-side: timestamp ordering + multiset send/receive."""
    prev_shard = view[f"{prefix}_prev_shard"]
    prev_clk = view[f"{prefix}_prev_clk"]
    compare_clk = view[f"{prefix}_compare_clk"]
    d16 = view[f"{prefix}_d16"]
    d8 = view[f"{prefix}_d8"]
    value = view.word(f"{prefix}_value")
    prev_value = view.word(f"{prefix}_prev_value") if write else value

    b.when(do_check).assert_bool(compare_clk)
    b.when(do_check).when(compare_clk).assert_eq(shard, prev_shard)
    prev_comp = compare_clk * prev_clk + (1 - compare_clk) * prev_shard
    cur_comp = compare_clk * clk + (1 - compare_clk) * shard
    diff_minus_one = cur_comp - prev_comp - 1
    b.when(do_check).assert_eq(diff_minus_one, d16 + d8 * 65536)
    send_byte(b, B.U16Range, d16, 0, 0, do_check)
    send_byte(b, B.U8Range, d8, 0, 0, do_check)

    b.send(
        LookupKind.Memory,
        [prev_shard, prev_clk, addr] + list(prev_value),
        do_check,
    )
    b.receive(LookupKind.Memory, [shard, clk, addr] + list(value), do_check)


def fill_access(w, rec_cols, pos_name, prefix, position, write: bool, record=None,
                shard: int = 1):
    """Trace-side fill from frozen record columns; also counts byte lookups.

    rec_cols: frozen record dict; pos_name: record position name ('a','b',...).
    """
    act = rec_cols[f"{pos_name}_act"].astype(np.int64)
    prev_clk = rec_cols[f"{pos_name}_prev_clk"].astype(np.int64)
    prev_shard = rec_cols[f"{pos_name}_prev_shard"].astype(np.int64)
    prev_value = rec_cols[f"{pos_name}_prev_value"]
    value = rec_cols[f"{pos_name}_value"]
    clk = rec_cols["clk"].astype(np.int64) + position
    compare = (prev_shard == shard).astype(np.int64) * act
    diff = np.where(compare == 1, clk - prev_clk - 1, shard - prev_shard - 1) * act
    d16 = diff & 0xFFFF
    d8 = diff >> 16
    assert np.all(diff >= 0) and np.all(diff < 1 << 24), "timestamp diff out of range"
    w.set(f"{prefix}_prev_shard", prev_shard * act)
    w.set(f"{prefix}_prev_clk", prev_clk * act)
    w.set(f"{prefix}_compare_clk", compare)
    w.set(f"{prefix}_d16", d16)
    w.set(f"{prefix}_d8", d8)
    w.set_word(f"{prefix}_value", value)
    if write:
        w.set_word(f"{prefix}_prev_value", prev_value)
    if record is not None:
        count(record, B.U16Range, d16, 0, act)
        count(record, B.U8Range, d8, 0, act)
