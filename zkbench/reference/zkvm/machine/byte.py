"""ByteChip: preprocessed 2^16-row table of byte operations
(reference: crates/core/machine/src/bytes/ — NUM_ROWS = 2^16, ops in
crates/core/executor/src/opcode.rs:195-216).

Byte lookup message: [op, x, y, z] (kind=Byte). Semantics per op:
  AND/OR/XOR/NOR: x, y bytes -> z = x op y
  LTU:            z = (x < y)
  MSB:            y = 0, z = msb(x)
  U8Range:        x, y both bytes, z = 0 (checks two bytes at once)
  U16Range:       x = 256*b + c < 2^16, y = z = 0
  SLL:            z = (x << (y % 8)) & 0xFF  (byte shift helper)
  ShrCarry:       z packed later (wired with the shift chips)
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .layout import Layout

# preprocessed layout
PREP = (
    Layout()
    .add("b")
    .add("c")
    .add("and")
    .add("or")
    .add("xor")
    .add("nor")
    .add("ltu")
    .add("msb")
    .add("u16")
    .add("sll")
    .add("shr")
    .add("shr_carry")
    .add("clz")
)

# main trace: one multiplicity column per op
OPS = ["and", "or", "xor", "nor", "ltu", "msb", "u8pair", "u16", "sll", "shr_carry", "clz8"]
MAIN = Layout()
for _op in OPS:
    MAIN.add(f"mult_{_op}")

_OP_IDS = {
    "and": B.AND,
    "or": B.OR,
    "xor": B.XOR,
    "nor": B.NOR,
    "ltu": B.LTU,
    "msb": B.MSB,
    "u8pair": B.U8Range,
    "u16": B.U16Range,
    "sll": B.SLL,
    "shr_carry": B.ShrCarry,
    "clz8": B.CLZ8,
}


class ByteChip(Air):
    COLS = MAIN  # picus layout resolution
    picus_inputs = tuple(MAIN._slices)  # multiplicities are free
    picus_outputs = ()
    name = "Byte"
    width = MAIN.width
    preprocessed_width = PREP.width
    local_only = True  # never opened at the next row

    def generate_preprocessed(self, program):
        n = 1 << 16
        w = PREP.writer(n)
        b = np.repeat(np.arange(256, dtype=np.uint32), 256)
        c = np.tile(np.arange(256, dtype=np.uint32), 256)
        w.set("b", b)
        w.set("c", c)
        w.set("and", b & c)
        w.set("or", b | c)
        w.set("xor", b ^ c)
        w.set("nor", (~(b | c)) & 0xFF)
        w.set("ltu", (b < c).astype(np.uint32))
        w.set("msb", (b >> 7) & 1)
        w.set("u16", b * 256 + c)
        sh = c % 8
        w.set("sll", (b << sh) & 0xFF)
        w.set("shr", b >> sh)
        w.set("shr_carry", (b & ((1 << sh) - 1)).astype(np.uint32))
        w.set("clz", np.array([8 - int(x).bit_length() for x in b], dtype=np.uint32))
        return w.mat

    def num_rows(self, record):
        return 1 << 16

    def generate_trace(self, record, output):
        n = 1 << 16
        w = MAIN.writer(n)
        id_to_col = {v: MAIN.idx(f"mult_{k}") for k, v in _OP_IDS.items()}
        for (op, x, y), mult in record.byte_counts.items():
            row = (x * 256 + y) if op != B.U16Range else x
            w.mat[row, id_to_col[op]] += mult % (2**31)
        return w.mat

    def eval(self, b):
        prep = PREP.view(b.prep_local)
        main = MAIN.view(b.main_local)
        x, y = prep["b"], prep["c"]
        recv = lambda op, vals, mult: b.receive(LookupKind.Byte, [int(op)] + vals, mult)
        recv(B.AND, [x, y, prep["and"]], main["mult_and"])
        recv(B.OR, [x, y, prep["or"]], main["mult_or"])
        recv(B.XOR, [x, y, prep["xor"]], main["mult_xor"])
        recv(B.NOR, [x, y, prep["nor"]], main["mult_nor"])
        recv(B.LTU, [x, y, prep["ltu"]], main["mult_ltu"])
        recv(B.MSB, [x, 0, prep["msb"]], main["mult_msb"])
        recv(B.U8Range, [x, y, 0], main["mult_u8pair"])
        recv(B.U16Range, [prep["u16"], 0, 0], main["mult_u16"])
        recv(B.SLL, [x, y, prep["sll"]], main["mult_sll"])
        recv(B.ShrCarry, [x, y, prep["shr"] * 256 + prep["shr_carry"]], main["mult_shr_carry"])
        recv(B.CLZ8, [x, 0, prep["clz"]], main["mult_clz8"])


# ---------------------------------------------------------------------------
# sender-side helpers: constraint-side sends + trace-side count accounting
# ---------------------------------------------------------------------------


def send_byte(b, op, x, y, z, mult):
    b.send(LookupKind.Byte, [int(op), x, y, z], mult)


def count(record, op, x, y, mult=None):
    """Vectorized byte-count accounting; x, y numpy arrays; mult 0/1 array.
    Aggregates per (x, y) pair before touching the dict — the per-element
    loop was the single hottest spot of shard trace generation."""
    x = np.asarray(x, dtype=np.int64).reshape(-1)
    y = np.broadcast_to(np.asarray(y, dtype=np.int64), x.shape)
    if mult is None:
        m = np.ones_like(x)
    else:
        m = np.broadcast_to(np.asarray(mult, dtype=np.int64), x.shape)
    sel = m != 0
    xs, ys, ms = x[sel], y[sel], m[sel]
    if xs.size == 0:
        return
    key = (xs << 32) | ys
    order = np.argsort(key, kind="stable")
    k = key[order]
    w = ms[order]
    starts = np.flatnonzero(np.concatenate(([True], k[1:] != k[:-1])))
    sums = np.add.reduceat(w, starts)
    uk = k[starts]
    bc = record.byte_counts
    opi = int(op)
    for kk, ss in zip(uk.tolist(), sums.tolist()):
        t = (opi, kk >> 32, kk & 0xFFFFFFFF)
        bc[t] = bc.get(t, 0) + ss


def count_u8_word(record, word_bytes, mult=None):
    """Range-check a (n, 4) byte matrix via two U8Range pair lookups."""
    count(record, B.U8Range, word_bytes[:, 0], word_bytes[:, 1], mult)
    count(record, B.U8Range, word_bytes[:, 2], word_bytes[:, 3], mult)


def send_u8_word(b, word_cols, mult):
    send_byte(b, B.U8Range, word_cols[0], word_cols[1], 0, mult)
    send_byte(b, B.U8Range, word_cols[2], word_cols[3], 0, mult)
