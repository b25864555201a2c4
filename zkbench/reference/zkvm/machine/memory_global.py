"""MemoryInitChip / MemoryFinalChip: offline memory-checking endpoints
(reference: crates/core/machine/src/memory/global.rs).

Multi-shard: init/finalize events may live in ANY shard (standalone memory
shards for big guests — executor/split.py), so per-shard address ordering
alone cannot prevent a cross-shard double init/finalize. The reference
chains four PublicValues fields (previous/last init/finalize addr bits,
air/public_values.rs:22-60) through every shard; this chip constrains:

  * the first real row's address is strictly GREATER than the packed
    `previous_*_addr_bits` pv — unless that packed value is zero (the
    bootstrap case: then the first row must BE address zero with value
    zero, exactly once across the whole execution — global.rs:397-421);
  * addresses strictly increase row to row (byte-lexicographic compare);
  * the last real row's address equals the packed `last_*_addr_bits` pv.

The cross-shard last -> previous equality is the verifier's job
(machine/mips.py verify_mips_proof + recursion/mips_pipeline.py lift/join).
The comparison against `previous` is by VALUE (a 31-bit range-checked
difference), which is sound because the previous shard bound the same
packed value to a range-checked address.

Soundness notes:
  * init values byte-range-checked (they enter the multiset unchecked);
  * the chip excludes itself from shards with no events (reference
    global.rs included()); the host verifier requires previous == last
    for shards without the chip.
"""

from __future__ import annotations

import numpy as np

from ..core.field import P_INT
from ..executor.opcode import ByteOpcode as B
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .layout import Layout, pack_word, pad_to_pow2, word_decompose_np
from .messages import (
    PV_LAST_FIN_ADDR,
    PV_LAST_INIT_ADDR,
    PV_PREV_FIN_ADDR,
    PV_PREV_INIT_ADDR,
)


def _layout(with_ts: bool) -> Layout:
    l = (
        Layout()
        .add("addr")
        .word("value")
        .word("addr_b")  # byte decomposition of addr (addr < 2^31, unique)
        .add("df", 4)  # one-hot: most significant byte where next > local
        .add("sel_lo").add("sel_hi")  # the compared byte pair
        .add("is_real")
        .add("has_next")  # is_real AND next row is real (lookup mults cannot
        # reference the next row, and the last row wraps around)
        .add("fc")  # is_first_comp: row 0 only; 1 iff prev pv addr != 0
        .add("prev_inv")  # row 0 witness: (packed prev addr)^-1 when fc=1
        .add("pdf", 4)  # row 0 one-hot: MS byte where addr0 > prev pv addr
        .add("psel_lo").add("psel_hi")  # row 0: the compared byte pair
    )
    if with_ts:
        l.add("shard").add("clk")
    return l


def _fill_common(w, addrs, values, n):
    w.set("addr", addrs)
    w.set_word("value", values)
    ab = word_decompose_np(np.asarray(addrs, dtype=np.int64))
    w.set_word("addr_b", np.asarray(addrs, dtype=np.int64))
    df = np.zeros((n, 4), dtype=np.uint32)
    sel_lo = np.zeros(n, dtype=np.uint32)
    sel_hi = np.zeros(n, dtype=np.uint32)
    for r in range(n - 1):
        for k in (3, 2, 1, 0):
            if ab[r + 1, k] != ab[r, k]:
                assert ab[r + 1, k] > ab[r, k], "addresses not increasing"
                df[r, k] = 1
                sel_lo[r] = ab[r, k]
                sel_hi[r] = ab[r + 1, k]
                break
        else:
            raise AssertionError("duplicate address in memory endpoints")
    w.set("df", df)
    w.set("sel_lo", sel_lo)
    w.set("sel_hi", sel_hi)
    w.set("is_real", np.ones(n))
    has_next = np.ones(n, dtype=np.uint32)
    if n:
        has_next[n - 1] = 0
    w.set("has_next", has_next)


def _prev_bytes(prev_bits) -> list:
    return [
        sum(int(prev_bits[8 * k + i]) << i for i in range(8)) for k in range(4)
    ]


def _fill_prev(w, addrs, values, prev_bits, n):
    """Row-0 columns for the cross-shard address chain: fc (is_first_comp),
    the packed-prev inverse witness, and the strict byte comparison of the
    first real address against the previous shard's last address."""
    assert n > 0, "memory endpoint chip requires at least one event"
    packed = sum(int(b) * pow(2, i, P_INT) for i, b in enumerate(prev_bits)) % P_INT
    if packed == 0:
        # bootstrap: exactly one zero-address endpoint across the execution
        assert int(addrs[0]) == 0, "first endpoint after prev=0 must be addr 0"
        assert int(values[0]) == 0, "zero-address endpoint value must be 0"
        assert n >= 2, "prev=0 shard needs a second endpoint (addr > 0)"
        return
    w.mat[0, w.layout.idx("fc")] = 1
    w.mat[0, w.layout.idx("prev_inv")] = pow(packed, P_INT - 2, P_INT)
    pb = _prev_bytes(prev_bits)
    a0 = [int(x) for x in word_decompose_np(np.array([addrs[0]], np.int64))[0]]
    for k in (3, 2, 1, 0):
        if a0[k] != pb[k]:
            assert a0[k] > pb[k], "first endpoint not above prev chain addr"
            w.mat[0, w.layout.slc("pdf")][k] = 1
            w.mat[0, w.layout.idx("psel_lo")] = pb[k]
            w.mat[0, w.layout.idx("psel_hi")] = a0[k]
            return
    raise AssertionError("first endpoint equals prev chain addr (double use)")


def _count_prev(record, addrs, prev_bits):
    """Byte-table multiplicity for the row-0 prev comparison LTU lookup."""
    packed = sum(int(b) * pow(2, i, P_INT) for i, b in enumerate(prev_bits)) % P_INT
    if packed == 0:
        return
    pb = _prev_bytes(prev_bits)
    a0 = [int(x) for x in word_decompose_np(np.array([addrs[0]], np.int64))[0]]
    for k in (3, 2, 1, 0):
        if a0[k] != pb[k]:
            count(record, B.LTU, np.array([pb[k]]), a0[k])
            return


def _eval_ordering(b, L, N):
    """Strictly increasing addresses among real rows, compared
    lexicographically on the byte decomposition (exact: addr < 2^31, so the
    decomposition is unique — no mod-p aliasing)."""
    b.assert_bool(L["is_real"])
    b.assert_bool(L["has_next"])
    # once padding starts it never stops
    b.when_transition().assert_zero(N["is_real"] * (1 - L["is_real"]))
    # has_next == is_real * next.is_real (and 0 on the physically last row)
    b.when_transition().assert_eq(L["has_next"], L["is_real"] * N["is_real"])
    b.when_last_row().assert_zero(L["has_next"])
    ab = L.word("addr_b")
    b.when(L["is_real"]).assert_eq(L["addr"], pack_word(ab))
    send_byte(b, B.U8Range, ab[0], ab[1], 0, L["is_real"])
    send_byte(b, B.U8Range, ab[2], ab[3], 0, L["is_real"])
    send_byte(b, B.MSB, ab[3], 0, 0, L["is_real"])
    df = L["df"]
    acc = 0
    for k in range(4):
        b.assert_bool(df[k])
        acc = df[k] + acc
    b.assert_eq(acc, L["has_next"])  # strict: a differing byte must exist
    nb = N.word("addr_b")
    # bytes above the flagged byte are equal
    for k in range(4):
        for j in range(k + 1, 4):
            b.when_transition().assert_zero(df[k] * (nb[j] - ab[j]))
    # the flagged byte pair goes through an LTU lookup with result 1
    b.when_transition().assert_eq(
        L["sel_lo"], df[0] * ab[0] + df[1] * ab[1] + df[2] * ab[2] + df[3] * ab[3]
    )
    b.when_transition().assert_eq(
        L["sel_hi"], df[0] * nb[0] + df[1] * nb[1] + df[2] * nb[2] + df[3] * nb[3]
    )
    b.when_last_row().assert_zero(L["sel_lo"])
    b.when_last_row().assert_zero(L["sel_hi"])
    send_byte(b, B.LTU, L["sel_lo"], L["sel_hi"], 1, L["has_next"])


def _eval_chain(b, L, N, prev_off, last_off):
    """Bind the first/last real rows to the PublicValues address chain
    (reference global.rs:355-445):

      * row 0 must be real (the chip is excluded from event-less shards);
      * fc (is_first_comp) = 1 iff the packed `previous_*_addr_bits` pv is
        nonzero, witnessed by `prev_inv`;
      * fc=1: the first address is strictly GREATER than prev, compared
        lexicographically on bytes (prev bytes are linear expressions of
        the pv bits; sound because each shard binds its last address at
        byte granularity, so the byte expressions chain exactly);
      * fc=0 (bootstrap): the first row is address 0 with value 0, and a
        second real row exists so `last_*` lands on an address > 0 —
        exactly one zero-address endpoint across the whole execution;
      * the last real row's address bytes equal `last_*_addr_bits`."""
    pv = b.public_values
    prev_bits = [pv[prev_off + i] for i in range(32)]
    prev_bytes = [
        sum(prev_bits[8 * k + i] * (1 << i) for i in range(1, 8))
        + prev_bits[8 * k]
        for k in range(4)
    ]
    packed = (
        sum(prev_bits[i] * pow(2, i, P_INT) for i in range(1, 32)) + prev_bits[0]
    )
    fc = L["fc"]
    b.assert_bool(fc)
    b.when_transition().assert_zero(N["fc"])
    b.when_first_row().assert_one(L["is_real"])
    # fc = (packed != 0), via the inverse witness
    b.when_first_row().assert_eq(packed * L["prev_inv"], fc)
    b.when_first_row().assert_zero(packed * (1 - fc))
    # bootstrap: addr 0, value 0, and at least two real rows
    nf = 1 - fc
    b.when_first_row().assert_zero(nf * L["addr"])
    for v in L.word("value"):
        b.when_first_row().assert_zero(nf * v)
    b.when_first_row().assert_zero(nf * (1 - L["has_next"]))
    # strict byte comparison addr0 > prev when fc
    pdf = L["pdf"]
    ab = L.word("addr_b")
    acc = 0
    for k in range(4):
        b.assert_bool(pdf[k])
        b.when_transition().assert_zero(N["pdf"][k])
        acc = pdf[k] + acc
    b.when_first_row().assert_eq(acc, fc)
    for k in range(4):
        for j in range(k + 1, 4):
            b.when_first_row().assert_zero(pdf[k] * (ab[j] - prev_bytes[j]))
    b.when_first_row().assert_eq(
        L["psel_lo"],
        pdf[0] * prev_bytes[0] + pdf[1] * prev_bytes[1]
        + pdf[2] * prev_bytes[2] + pdf[3] * prev_bytes[3],
    )
    b.when_first_row().assert_eq(
        L["psel_hi"],
        pdf[0] * ab[0] + pdf[1] * ab[1] + pdf[2] * ab[2] + pdf[3] * ab[3],
    )
    send_byte(b, B.LTU, L["psel_lo"], L["psel_hi"], 1, fc)
    # last real row: address bytes == last_*_addr_bits
    last_bytes = [
        sum(pv[last_off + 8 * k + i] * (1 << i) for i in range(1, 8))
        + pv[last_off + 8 * k]
        for k in range(4)
    ]
    is_last_real = L["is_real"] - L["has_next"]  # boolean: has_next <= is_real
    for k in range(4):
        b.when_transition().when(is_last_real).assert_eq(ab[k], last_bytes[k])
        b.when_last_row().when(L["is_real"]).assert_eq(ab[k], last_bytes[k])


def _count_ordering(record, addrs, n):
    if n == 0:
        return
    ab = word_decompose_np(np.asarray(addrs, dtype=np.int64))
    count_u8_word(record, ab)
    count(record, B.MSB, ab[:, 3], 0)
    for r in range(n - 1):
        for k in (3, 2, 1, 0):
            if ab[r + 1, k] != ab[r, k]:
                count(record, B.LTU, ab[r : r + 1, k], ab[r + 1, k])
                break


class MemoryInitChip(Air):
    name = "MemoryInit"
    COLS = _layout(with_ts=False)
    width = COLS.width
    # determinism: given the (pv-chained) address stream, every ordering
    # witness column is derived
    picus_inputs = ("addr", "value", "is_real")
    picus_outputs = ("addr_b", "df", "sel_lo", "sel_hi", "has_next", "fc",
                     "prev_inv", "pdf", "psel_lo", "psel_hi")

    def included(self, record):
        return len(record.mem_init) > 0

    def generate_dependencies(self, record, output):
        addrs = np.array([a for a, _ in record.mem_init], dtype=np.int64)
        vals = np.array([v for _, v in record.mem_init], dtype=np.int64)
        n = len(addrs)
        count_u8_word(record, word_decompose_np(vals))
        _count_ordering(record, addrs, n)
        _count_prev(record, addrs, record.public_values.previous_init_addr_bits)

    def num_rows(self, record):
        return len(record.mem_init)

    def generate_trace(self, record, output):
        addrs = np.array([a for a, _ in record.mem_init], dtype=np.int64)
        vals = np.array([v for _, v in record.mem_init], dtype=np.int64)
        n = len(addrs)
        w = self.COLS.writer(n)
        _fill_common(w, addrs, vals, n)
        _fill_prev(w, addrs, vals,
                   record.public_values.previous_init_addr_bits, n)
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = self.COLS.view(b.main_local)
        N = self.COLS.view(b.main_next)
        _eval_ordering(b, L, N)
        _eval_chain(b, L, N, PV_PREV_INIT_ADDR, PV_LAST_INIT_ADDR)
        send_u8_word(b, L.word("value"), L["is_real"])
        # overall init endpoint: a global *send* (cancels the first shard's
        # initial-tuple receive in the septic digest)
        b.send(
            LookupKind.Global,
            [0, 0, L["addr"]] + list(L.word("value"))
            + [L["is_real"], 0, int(LookupKind.Memory)],
            L["is_real"],
        )


class MemoryFinalChip(Air):
    name = "MemoryFinal"
    COLS = _layout(with_ts=True)
    width = COLS.width
    picus_inputs = ("addr", "value", "shard", "clk", "is_real")
    picus_outputs = ("addr_b", "df", "sel_lo", "sel_hi", "has_next", "fc",
                     "prev_inv", "pdf", "psel_lo", "psel_hi")

    def included(self, record):
        return len(record.mem_final) > 0

    def generate_dependencies(self, record, output):
        addrs = np.array([a for a, _, _, _ in record.mem_final], dtype=np.int64)
        _count_ordering(record, addrs, len(addrs))
        _count_prev(record, addrs,
                    record.public_values.previous_finalize_addr_bits)

    def num_rows(self, record):
        return len(record.mem_final)

    def generate_trace(self, record, output):
        addrs = np.array([a for a, _, _, _ in record.mem_final], dtype=np.int64)
        shards = np.array([s for _, s, _, _ in record.mem_final], dtype=np.int64)
        clks = np.array([c for _, _, c, _ in record.mem_final], dtype=np.int64)
        vals = np.array([v for _, _, _, v in record.mem_final], dtype=np.int64)
        n = len(addrs)
        w = self.COLS.writer(n)
        _fill_common(w, addrs, vals, n)
        _fill_prev(w, addrs, vals,
                   record.public_values.previous_finalize_addr_bits, n)
        w.set("shard", shards)
        w.set("clk", clks)
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = self.COLS.view(b.main_local)
        N = self.COLS.view(b.main_next)
        _eval_ordering(b, L, N)
        _eval_chain(b, L, N, PV_PREV_FIN_ADDR, PV_LAST_FIN_ADDR)
        # overall finalize endpoint: a global *receive*
        b.send(
            LookupKind.Global,
            [L["shard"], L["clk"], L["addr"]] + list(L.word("value"))
            + [0, L["is_real"], int(LookupKind.Memory)],
            L["is_real"],
        )
