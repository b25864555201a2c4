"""KeccakSpongeChip: the KECCAK_SPONGE precompile — 24 rows per absorbed
36-u32 block on top of the shared Keccak-f round columns (keccak_air.py)
(reference: crates/core/machine/src/syscall/precompiles/keccak/air.rs; the
row/bit layout here is this engine's own design).

Sponge control on top of the permutation block:
  * an event spans `nb` blocks = 24*nb consecutive rows; shard/clk/ptrs and
    n_u32 are copied down the event (gated by `cont` = is_real - wr_flag);
  * `ev_start` marks the first row of an event: receives the Syscall-kind
    dispatch, reads the input length at result_ptr + 64 (bound byte-wise to
    n_u32, which requires the length < 2^24 u32s — 64 MB of input), and
    absorbs block 0 into a zero state (a = in_bits on lanes 0..17, 0 above);
  * `abs_flag` (= round0 AND is_real) gates the 36 input-word reads of each
    block at input_ptr + 4*(36*block_idx + i); word bytes are bound to the
    committed in_bits plane, and a continuing block's `a` is the previous
    round-23 `aout` xor in_bits (via the committed `blk_cont` flag so the
    transition constraint stays degree 3);
  * `wr_flag` (= round23 AND is_last_block AND is_real) gates the 16 output
    word writes at result_ptr + 4*i at clk + 1, bound byte-wise to `aout`
    bits of lanes 0..7, and pins n_u32 = 36*(block_idx + 1).

Padding rows continue zero-state Keccak-f chains so the ungated permutation
constraints hold; every control flag is zero there.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import SyscallCode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count
from .keccak_air import (
    NR,
    add_perm_layout,
    eval_perm,
    fill_perm_padding,
    fill_perm_row,
)
from .layout import Layout, trace_height
from .memory_access import add_access_cols, eval_access, fill_access

N_IN = 36  # u32 words absorbed per block
N_OUT = 16  # u32 words written back

COLS = add_perm_layout(Layout())
COLS.add("shard").add("clk").add("input_ptr").add("result_ptr")
COLS.add("n_u32").add("block_idx")
COLS.add("is_real").add("ev_start").add("abs_flag").add("is_last_block")
COLS.add("wr_flag").add("blk_cont")
COLS.add("in_bits", N_IN * 32)
add_access_cols(COLS, "len", write=False)
for i in range(N_IN):
    add_access_cols(COLS, f"in{i}", write=False)
for i in range(N_OUT):
    add_access_cols(COLS, f"out{i}", write=True)


class KeccakSpongeChip(Air):
    picus_inputs = ("shard", "clk", "input_ptr", "result_ptr", "n_u32",
                    "block_idx", "is_real", "ev_start", "abs_flag",
                    "is_last_block", "wr_flag", "blk_cont")
    picus_outputs = ("in_bits",)
    def num_rows(self, record):
        return sum(
            NR * (len(e["reads"]) // N_IN) for e in self._events(record)
        )

    name = "KeccakSponge"
    width = COLS.width

    def _events(self, record):
        return record.precompile_events.get(int(SyscallCode.KECCAK_SPONGE), [])

    def included(self, record):
        return bool(self._events(record))

    def generate_dependencies(self, record, output):
        for ev in self._events(record):
            clk, shard = ev["clk"], ev["shard"]
            accesses = [(clk, ev["len_read"])]
            accesses += [(clk, r) for r in ev["reads"]]
            accesses += [(clk + 1, w) for w in ev["writes"]]
            for ts, acc in accesses:
                prev_clk, prev_shard = acc[2], acc[3]
                compare = 1 if prev_shard == shard else 0
                diff = (ts - prev_clk - 1) if compare else (shard - prev_shard - 1)
                count(record, B.U16Range, np.array([diff & 0xFFFF]), 0)
                count(record, B.U8Range, np.array([diff >> 16]), 0)

    def generate_trace(self, record, output):
        events = self._events(record)
        n_real = sum(NR * (len(e["reads"]) // N_IN) for e in events)
        height = trace_height(n_real, 32)
        mat = np.zeros((height, COLS.width), dtype=np.uint32)
        row = 0
        for ev in events:
            nb = len(ev["reads"]) // N_IN
            assert ev["len_read"][1] == N_IN * nb
            for blk in range(nb):
                cur = list(ev["xored_states"][blk])
                blk_words = ev["input"][N_IN * blk : N_IN * (blk + 1)]
                for rnd in range(NR):
                    r = mat[row]
                    cur = fill_perm_row(r, COLS, cur, rnd)
                    r[COLS.idx("shard")] = ev["shard"]
                    r[COLS.idx("clk")] = ev["clk"]
                    r[COLS.idx("input_ptr")] = ev["input_ptr"]
                    r[COLS.idx("result_ptr")] = ev["result_ptr"]
                    r[COLS.idx("n_u32")] = N_IN * nb
                    r[COLS.idx("block_idx")] = blk
                    r[COLS.idx("is_real")] = 1
                    r[COLS.idx("is_last_block")] = int(blk == nb - 1)
                    if rnd == 0:
                        r[COLS.idx("abs_flag")] = 1
                        if blk == 0:
                            r[COLS.idx("ev_start")] = 1
                        bits = np.zeros(N_IN * 32, dtype=np.uint32)
                        for i, w in enumerate(blk_words):
                            for z in range(32):
                                bits[32 * i + z] = (int(w) >> z) & 1
                        r[COLS.slc("in_bits")] = bits
                        self._fill_row_accesses(
                            r, [("len", ev["len_read"], 0)] if blk == 0 else [],
                            ev["clk"], ev["shard"],
                        )
                        self._fill_row_accesses(
                            r,
                            [
                                (f"in{i}", ev["reads"][N_IN * blk + i], 0)
                                for i in range(N_IN)
                            ],
                            ev["clk"], ev["shard"],
                        )
                    if rnd == NR - 1 and blk == nb - 1:
                        r[COLS.idx("wr_flag")] = 1
                        self._fill_row_accesses(
                            r,
                            [(f"out{i}", ev["writes"][i], 1) for i in range(N_OUT)],
                            ev["clk"], ev["shard"], write=True,
                        )
                    if rnd == NR - 1 and blk < nb - 1:
                        r[COLS.idx("blk_cont")] = 1
                    row += 1
        fill_perm_padding(mat, COLS, row)
        return mat

    @staticmethod
    def _fill_row_accesses(r, named, clk, shard, write=False):
        for prefix, acc, ts_off in named:
            addr, prev_v, prev_clk, prev_shard = acc[0], acc[1], acc[2], acc[3]
            value = acc[4] if write else acc[1]
            compare = 1 if prev_shard == shard else 0
            ts = clk + ts_off
            diff = (ts - prev_clk - 1) if compare else (shard - prev_shard - 1)
            r[COLS.idx(f"{prefix}_prev_shard")] = prev_shard
            r[COLS.idx(f"{prefix}_prev_clk")] = prev_clk
            r[COLS.idx(f"{prefix}_compare_clk")] = compare
            r[COLS.idx(f"{prefix}_d16")] = diff & 0xFFFF
            r[COLS.idx(f"{prefix}_d8")] = diff >> 16
            for j in range(4):
                r[COLS.slc(f"{prefix}_value")][j] = (int(value) >> (8 * j)) & 0xFF
                if write:
                    r[COLS.slc(f"{prefix}_prev_value")][j] = (
                        int(prev_v) >> (8 * j)
                    ) & 0xFF

    def eval(self, b):
        L = COLS.view(b.main_local)
        N = COLS.view(b.main_next)
        eval_perm(b, L, N)

        R = L["round"]
        is_real = L["is_real"]
        ev_start = L["ev_start"]
        abs_flag = L["abs_flag"]
        ilb = L["is_last_block"]
        wr_flag = L["wr_flag"]
        blk_cont = L["blk_cont"]
        for f in (is_real, ev_start, abs_flag, ilb, wr_flag, blk_cont):
            b.assert_bool(f)
        # flag definitions
        b.assert_eq(abs_flag, R[0] * is_real)
        b.assert_eq(wr_flag, R[NR - 1] * ilb * is_real)
        cont = is_real - wr_flag  # event continues to the next row
        b.assert_eq(blk_cont, R[NR - 1] * cont)
        b.assert_zero(ilb * (1 - is_real))
        # event starts exactly on real rows not continued into
        b.assert_zero(ev_start * (1 - abs_flag))
        b.assert_zero(ev_start * L["block_idx"])
        b.when_first_row().assert_zero(is_real * (1 - ev_start))
        b.when_transition().assert_zero(cont * N["ev_start"])
        b.when_transition().assert_zero(
            N["is_real"] * (1 - cont) * (1 - N["ev_start"])
        )
        # copies down the event
        for nm in ("shard", "clk", "input_ptr", "result_ptr", "n_u32"):
            b.when_transition().assert_zero(cont * (N[nm] - L[nm]))
        b.when_transition().assert_zero(
            cont * (N["block_idx"] - L["block_idx"] - R[NR - 1])
        )
        # n_u32 pinned on the write row; < 2^24 enforced at the length read
        b.assert_zero(wr_flag * (L["n_u32"] - N_IN * (L["block_idx"] + 1)))

        # syscall dispatch
        b.receive(
            LookupKind.Syscall,
            [L["shard"], L["clk"], int(SyscallCode.KECCAK_SPONGE),
             L["input_ptr"], L["result_ptr"]],
            ev_start,
        )
        # length read: n_u32 = 3 low bytes of the value (top byte must be 0)
        eval_access(b, L, "len", L["shard"], L["clk"],
                    L["result_ptr"] + 64, ev_start, write=False)
        lv = L.word("len_value")
        b.assert_zero(ev_start * lv[3])
        b.assert_zero(
            ev_start * (L["n_u32"] - (lv[0] + lv[1] * 256 + lv[2] * 65536))
        )

        # input reads + byte binding to in_bits
        ib = L["in_bits"]
        for i in range(N_IN * 32):
            b.assert_bool(ib[i])
            b.assert_zero((1 - abs_flag) * ib[i])
        for i in range(N_IN):
            eval_access(
                b, L, f"in{i}", L["shard"], L["clk"],
                L["input_ptr"] + 4 * (N_IN * L["block_idx"] + i),
                abs_flag, write=False,
            )
            wv = L.word(f"in{i}_value")
            for j in range(4):
                byte = 0
                for k in range(8):
                    byte = ib[32 * i + 8 * j + k] * (1 << k) + byte
                b.assert_zero(abs_flag * (wv[j] - byte))

        # absorb: event start (zero state) — a = in_bits on lanes 0..17
        a = L["a"]
        for l in range(18):
            for z in range(64):
                w32, zz = (2 * l, z) if z < 32 else (2 * l + 1, z - 32)
                b.assert_zero(
                    ev_start * (a[64 * l + z] - ib[32 * w32 + zz])
                )
        for l in range(18, 25):
            for z in range(64):
                b.assert_zero(ev_start * a[64 * l + z])
        # absorb: continuing block — next.a = aout xor next.in_bits
        aout = L["aout"]
        Na = N["a"]
        Nib = N["in_bits"]
        for l in range(18):
            for z in range(64):
                w32, zz = (2 * l, z) if z < 32 else (2 * l + 1, z - 32)
                o = aout[64 * l + z]
                x = Nib[32 * w32 + zz]
                b.when_transition().assert_zero(
                    blk_cont * (Na[64 * l + z] - (o + x - 2 * o * x))
                )
        for l in range(18, 25):
            for z in range(64):
                b.when_transition().assert_zero(
                    blk_cont * (Na[64 * l + z] - aout[64 * l + z])
                )

        # output writes bound to aout bits of lanes 0..7
        for i in range(N_OUT):
            eval_access(
                b, L, f"out{i}", L["shard"], L["clk"] + 1,
                L["result_ptr"] + 4 * i, wr_flag, write=True,
            )
            wv = L.word(f"out{i}_value")
            lane, half = i // 2, i % 2
            for j in range(4):
                byte = 0
                for k in range(8):
                    byte = aout[64 * lane + 32 * half + 8 * j + k] * (1 << k) + byte
                b.assert_zero(wr_flag * (wv[j] - byte))