"""ShaCompressChip: the SHA-256 compression-function precompile
(reference: crates/core/machine/src/syscall/precompiles/sha256/compress).

One row per round i in [0, 64). Row 0 reads h[0..8] (the working state) and
receives the dispatch; every row reads w[i]; row 63 writes h'[j] =
h_init[j] + state_out[j]. The round keys K[i] are selected by a one-hot
round counter that shifts along the chained rows. ch/maj run through the
byte table (AND/XOR lookups); S0/S1 are bit-rotation expressions over the
bit decompositions of a and e. All word sums are byte-level carry adders
(exact integer equations, immune to mod-p aliasing).
"""

from __future__ import annotations

import numpy as np

from ..executor.executor import _SHA256_K
from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import SyscallCode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .layout import Layout, pack_word, pad_to_pow2, word_decompose_np
from .memory_access import add_access_cols, eval_access, fill_access

STATE = ["a", "b", "c", "d", "e", "f", "g", "h"]

COLS = Layout().add("shard").add("clk").add("w_ptr").add("h_ptr")
COLS.add("r", 64)  # one-hot round counter
for nm in STATE:
    COLS.word(f"s_{nm}")  # round input state
for j in range(8):
    COLS.word(f"hi_{j}")  # initial h (passthrough)
COLS.add("ba", 32).add("be", 32)  # bits of a and e
COLS.add("ch_t1", 4).add("ch_t2", 4).add("ch", 4)  # ch = (e&f)^(~e&g)
COLS.add("mj_1", 4).add("mj_2", 4).add("mj_3", 4).add("mj_x", 4).add("mj", 4)
COLS.add("s0B", 4).add("s1B", 4)  # sigma bytes (defined from the bits)
COLS.add("t1B", 4)  # temp1 bytes (defined by a byte adder, U8-checked)
COLS.add("t1c", 12)  # temp1 adder carries (3 bits x 4)
COLS.add("ac", 12)  # round: a' adder carries / last row: finalize-a carries
COLS.add("ec", 8)  # round: e' adder carries / last row: finalize-e carries
COLS.add("wc", 24)  # finalize carries for the six shifted words (1 bit each)
add_access_cols(COLS, "w_acc", write=False)
for j in range(8):
    add_access_cols(COLS, f"hr{j}", write=False)
for j in range(8):
    add_access_cols(COLS, f"hw{j}", write=True)
COLS.add("is_real")


def _xor2(x, y):
    return x + y - 2 * (x * y)


class ShaCompressChip(Air):
    picus_inputs = ("shard", "clk", "w_ptr", "h_ptr", "r", "is_real")
    picus_outputs = ("ba", "be", "ch_t1", "ch_t2", "ch", "mj_1", "mj_2",
                     "mj_3", "mj_x", "mj", "s0B", "s1B", "t1B", "t1c",
                     "ac", "ec", "wc")
    def num_rows(self, record):
        return 64 * len(self._events(record))

    name = "ShaCompress"
    width = COLS.width

    def _events(self, record):
        return record.precompile_events.get(int(SyscallCode.SHA_COMPRESS), [])

    def included(self, record):
        return bool(self._events(record))

    @staticmethod
    def _event_arrays(events):
        """The events' fields and accesses as int64 arrays: shard, clk, w_ptr,
        h_ptr (E,); h_reads (E, 8, 4) and w_reads (E, 64, 4), each access
        (addr, value, prev_clk, prev_shard); h_writes (E, 8, 5), (addr,
        prev_value, prev_clk, prev_shard, value)."""
        return {key: np.array([ev[key] for ev in events], dtype=np.int64)
                for key in ("shard", "clk", "w_ptr", "h_ptr", "h_reads", "w_reads",
                            "h_writes")}

    @staticmethod
    def _round_states(hs, ws):
        """The 64 round-input states of every event, (E, 64, 8), from the
        initial words hs (E, 8) and the schedules ws (E, 64), and each round's
        S1, ch, temp1, S0 and maj, (5, E, 64). The rounds run in turn, each
        over all events."""
        ror = lambda x, r: ((x >> r) | (x << (32 - r))) & 0xFFFFFFFF
        states = np.empty(ws.shape + (8,), dtype=np.int64)
        rnd = np.empty((5,) + ws.shape, dtype=np.int64)
        a, b, c, d, e, f, g, h = hs.T
        for i in range(64):
            states[:, i] = np.stack([a, b, c, d, e, f, g, h], axis=1)
            S1 = ror(e, 6) ^ ror(e, 11) ^ ror(e, 25)
            ch = (e & f) ^ ((~e & 0xFFFFFFFF) & g)
            t1 = (h + S1 + ch + _SHA256_K[i] + ws[:, i]) & 0xFFFFFFFF
            S0 = ror(a, 2) ^ ror(a, 13) ^ ror(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            rnd[:, :, i] = S1, ch, t1, S0, maj
            h, g, f, e, d, c, b, a = (
                g, f, e, (d + t1) & 0xFFFFFFFF, c, b, a, (t1 + S0 + maj) & 0xFFFFFFFF
            )
        return states, rnd

    @staticmethod
    def _access_diffs(acc, ts, shard):
        """compare_clk and the timestamp diff of the accesses acc (..., 4+),
        made at ts in shard (each broadcast to acc[..., 0])."""
        prev_clk, prev_shard = acc[..., 2], acc[..., 3]
        compare = prev_shard == shard
        return compare, np.where(compare, ts - prev_clk - 1, shard - prev_shard - 1)

    def generate_dependencies(self, record, output):
        events = self._events(record)
        if not events:
            return
        ev = self._event_arrays(events)
        states, (_S1, _ch, t1, _S0, _maj) = self._round_states(
            ev["h_reads"][..., 1], ev["w_reads"][..., 1])
        ab, bb, cb, _db, eb, fb, gb, _hb = (
            states[..., j, None] >> np.arange(0, 32, 8) & 0xFF for j in range(8))
        ne = 255 - eb
        m1, m2, m3 = ab & bb, ab & cb, bb & cb
        # ch and maj: the AND and XOR lookups of every round's four bytes
        count(record, B.AND, np.concatenate([eb, ne, ab, ab, bb], axis=None),
              np.concatenate([fb, gb, bb, cb, cb], axis=None))
        count(record, B.XOR, np.concatenate([eb & fb, m1 ^ m2, m1], axis=None),
              np.concatenate([ne & gb, m3, m2], axis=None))
        count_u8_word(record, word_decompose_np(
            np.concatenate([t1, ev["h_writes"][..., 4]], axis=None)))
        # memory diffs
        clk, shard = ev["clk"][:, None], ev["shard"][:, None]
        diff = np.concatenate([self._access_diffs(ev["h_reads"], clk, shard)[1],
                               self._access_diffs(ev["w_reads"], clk, shard)[1],
                               self._access_diffs(ev["h_writes"], clk + 1, shard)[1]],
                              axis=None)
        count(record, B.U16Range, diff & 0xFFFF, 0)
        count(record, B.U8Range, diff >> 16, 0)

    def generate_trace(self, record, output):
        """Every event's 64 rows (row 64 * e + i is round i of event e),
        filled column by column."""
        events = self._events(record)
        n = 64 * len(events)
        w = COLS.writer(n)
        if not events:
            return pad_to_pow2(w.mat, min_height=64)
        ev = self._event_arrays(events)
        rows = np.arange(n)
        per_row = lambda v: np.repeat(v, 64, axis=0)
        for nm in ("shard", "clk", "w_ptr", "h_ptr"):
            w.set(nm, per_row(ev[nm]))
        w.mat[rows, COLS.slc("r").start + rows % 64] = 1
        hs = ev["h_reads"][..., 1]
        states, rnd = self._round_states(hs, ev["w_reads"][..., 1])
        a, b, c, d, e, f, g, h = states.reshape(n, 8).T
        S1, ch, t1, S0, maj = rnd.reshape(5, n)
        hi = per_row(hs)
        for j, v in enumerate((a, b, c, d, e, f, g, h)):
            w.set_word(f"s_{STATE[j]}", v)
            w.set_word(f"hi_{j}", hi[:, j])
        w.set("ba", a[:, None] >> np.arange(32) & 1)
        w.set("be", e[:, None] >> np.arange(32) & 1)
        for nm, v in (("ch_t1", e & f), ("ch_t2", ~e & 0xFFFFFFFF & g), ("ch", ch),
                      ("mj_1", a & b), ("mj_2", a & c), ("mj_3", b & c),
                      ("mj_x", (a & b) ^ (a & c)), ("mj", maj),
                      ("s0B", S0), ("s1B", S1), ("t1B", t1)):
            w.set_word(nm, v)
        k_i = np.array(_SHA256_K, dtype=np.int64)[rows % 64]
        self._fill_carries(w, "t1c", [h, S1, ch, k_i, ev["w_reads"][..., 1].reshape(n)], 3)
        # on the last row, the carries that finalize a and e: the same sums
        # plus h_init
        last = rows % 64 == 63
        self._fill_carries(w, "ac", [t1, S0, maj, np.where(last, hi[:, 0], 0)], 3)
        self._fill_carries(w, "ec", [d, t1, np.where(last, hi[:, 4], 0)], 2)
        # the last row's six shifted words: out + h_init, 1-bit carries per byte
        r63 = rows[last]
        shifted = states[:, 63][:, [0, 1, 2, 4, 5, 6]]
        his = hs[:, [1, 2, 3, 5, 6, 7]]
        cur = 0
        for k in range(4):
            cur = ((shifted >> 8 * k & 0xFF) + (his >> 8 * k & 0xFF) + cur) >> 8
            w.mat[r63[:, None], COLS.slc("wc").start + 4 * np.arange(6) + k] = cur
        # memory access cols: the h reads on row 0, the h writes on row 63,
        # a w read on every row
        for j in range(8):
            self._fill_one_access(w, r63 - 63, f"hr{j}", ev["h_reads"][:, j], ev["clk"],
                                  ev["shard"])
            self._fill_one_access(w, r63, f"hw{j}", ev["h_writes"][:, j], ev["clk"] + 1,
                                  ev["shard"])
        self._fill_one_access(w, rows, "w_acc", ev["w_reads"].reshape(n, 4),
                              per_row(ev["clk"]), per_row(ev["shard"]))
        w.mat[:n, COLS.idx("is_real")] = 1
        return pad_to_pow2(w.mat, min_height=64)

    @staticmethod
    def _fill_carries(w, name, terms, bits):
        """The byte adder's carries of the terms (n,), `bits` bits a byte."""
        cur = 0
        for k in range(4):
            s = sum((t >> (8 * k)) & 0xFF for t in terms) + cur
            cur = s >> 8
            for t in range(bits):
                w.mat[:, COLS.slc(name).start + bits * k + t] = (cur >> t) & 1

    @classmethod
    def _fill_one_access(cls, w, rows, prefix, acc, ts, shard):
        """One access of each of the given rows: acc (m, 4) are reads (addr,
        value, prev_clk, prev_shard), (m, 5) writes (addr, prev_value,
        prev_clk, prev_shard, value), made at ts (m,) in shard (m,)."""
        compare, diff = cls._access_diffs(acc, ts, shard)
        assert np.all((0 <= diff) & (diff < (1 << 24)))
        w.mat[rows, COLS.idx(f"{prefix}_prev_shard")] = acc[:, 3]
        w.mat[rows, COLS.idx(f"{prefix}_prev_clk")] = acc[:, 2]
        w.mat[rows, COLS.idx(f"{prefix}_compare_clk")] = compare
        w.mat[rows, COLS.idx(f"{prefix}_d16")] = diff & 0xFFFF
        w.mat[rows, COLS.idx(f"{prefix}_d8")] = diff >> 16
        if f"{prefix}_prev_value" in COLS:
            w.mat[rows, COLS.slc(f"{prefix}_prev_value")] = word_decompose_np(acc[:, 1])
            w.mat[rows, COLS.slc(f"{prefix}_value")] = word_decompose_np(acc[:, 4])
        else:
            w.mat[rows, COLS.slc(f"{prefix}_value")] = word_decompose_np(acc[:, 1])

    def eval(self, b):
        L = COLS.view(b.main_local)
        N = COLS.view(b.main_next)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        r = L["r"]
        acc = 0
        for i in range(64):
            b.assert_bool(r[i])
            acc = r[i] + acc
        b.assert_eq(acc, is_real)
        is_first, is_last = r[0], r[63]
        b.when_first_row().when(is_real).assert_one(is_first)
        b.when_transition().assert_zero(N["is_real"] * (1 - is_real))
        b.when_last_row().when(is_real).assert_one(is_last)

        # dispatch
        b.receive(
            LookupKind.Syscall,
            [L["shard"], L["clk"], int(SyscallCode.SHA_COMPRESS), L["w_ptr"],
             L["h_ptr"]],
            is_first,
        )

        # chaining
        chain = is_real * (1 - is_last)
        nr = N["r"]
        b.when_transition().assert_zero(chain * (1 - N["is_real"]))
        for i in range(63):
            b.when_transition().assert_zero(chain * (nr[i + 1] - r[i]))
        for nm in ("shard", "clk", "w_ptr", "h_ptr"):
            b.when_transition().assert_zero(chain * (N[nm] - L[nm]))
        for j in range(8):
            hj, nhj = L.word(f"hi_{j}"), N.word(f"hi_{j}")
            for k in range(4):
                b.when_transition().assert_zero(chain * (nhj[k] - hj[k]))
        b.when_transition().when(is_last * N["is_real"]).assert_one(nr[0])

        # row 0 state == h_init == h reads
        for j in range(8):
            eval_access(
                b, L, f"hr{j}", L["shard"], L["clk"], L["h_ptr"] + 4 * j,
                is_first, write=False,
            )
            for k in range(4):
                b.when(is_first).assert_eq(
                    L.word(f"hi_{j}")[k], L.word(f"hr{j}_value")[k]
                )
                b.when(is_first).assert_eq(
                    L.word(f"s_{STATE[j]}")[k], L.word(f"hi_{j}")[k]
                )

        # w[i] read: address selected by the one-hot round counter
        w_off = sum(r[i] * (4 * i) for i in range(64))
        eval_access(
            b, L, "w_acc", L["shard"], L["clk"], L["w_ptr"] + w_off,
            is_real, write=False,
        )

        # bits of a and e bound per byte
        ba, be = L["ba"], L["be"]
        for j in range(32):
            b.assert_bool(ba[j])
            b.assert_bool(be[j])
        byte_of = lambda bits, k: sum(bits[8 * k + t] * (1 << t) for t in range(8))
        for k in range(4):
            b.assert_eq(byte_of(ba, k), L.word("s_a")[k])
            b.assert_eq(byte_of(be, k), L.word("s_e")[k])

        # ch and maj through the byte table
        e_w, f_w, g_w = L.word("s_e"), L.word("s_f"), L.word("s_g")
        a_w, b_w, c_w = L.word("s_a"), L.word("s_b"), L.word("s_c")
        ch_t1, ch_t2, ch = L["ch_t1"], L["ch_t2"], L["ch"]
        m1, m2, m3, mx, mj = L["mj_1"], L["mj_2"], L["mj_3"], L["mj_x"], L["mj"]
        for k in range(4):
            send_byte(b, B.AND, e_w[k], f_w[k], ch_t1[k], is_real)
            send_byte(b, B.AND, 255 - e_w[k], g_w[k], ch_t2[k], is_real)
            send_byte(b, B.XOR, ch_t1[k], ch_t2[k], ch[k], is_real)
            send_byte(b, B.AND, a_w[k], b_w[k], m1[k], is_real)
            send_byte(b, B.AND, a_w[k], c_w[k], m2[k], is_real)
            send_byte(b, B.AND, b_w[k], c_w[k], m3[k], is_real)
            send_byte(b, B.XOR, m1[k], m2[k], mx[k], is_real)
            send_byte(b, B.XOR, mx[k], m3[k], mj[k], is_real)

        # sigma bytes defined from the bits (ungated, degree 3;
        # padding rows are all-zero and satisfy them)
        s1_bits = [self._ror_xor(be, j, (6, 11, 25)) for j in range(32)]
        s0_bits = [self._ror_xor(ba, j, (2, 13, 22)) for j in range(32)]
        s0B, s1B, t1B = L["s0B"], L["s1B"], L["t1B"]
        for k in range(4):
            b.assert_eq(
                s1B[k], sum(s1_bits[8 * k + t] * (1 << t) for t in range(8))
            )
            b.assert_eq(
                s0B[k], sum(s0_bits[8 * k + t] * (1 << t) for t in range(8))
            )
        send_u8_word(b, t1B, is_real)

        # K bytes selected by the round counter
        kb = word_decompose_np(np.array(_SHA256_K, dtype=np.int64))  # (64, 4)
        k_byte = lambda k: sum(r[i] * int(kb[i, k]) for i in range(64))

        # temp1 = h + S1 + ch + K + w: byte adder defining t1B (ungated)
        h_w = L.word("s_h")
        wv = L.word("w_acc_value")
        t1c = L["t1c"]
        prev = 0
        for k in range(4):
            carry = t1c[3 * k] + 2 * t1c[3 * k + 1] + 4 * t1c[3 * k + 2]
            for t in range(3):
                b.assert_bool(t1c[3 * k + t])
            b.assert_zero(
                h_w[k] + s1B[k] + ch[k] + k_byte(k) + wv[k] + prev
                - t1B[k] - carry * 256
            )
            prev = carry

        # round transition: a' = temp1 + S0 + maj, e' = d + temp1,
        # others shift (gated by chain)
        ac, ec = L["ac"], L["ec"]
        for t in range(12):
            b.assert_bool(ac[t])
        for t in range(8):
            b.assert_bool(ec[t])
        d_w = L.word("s_d")
        na, ne = N.word("s_a"), N.word("s_e")
        prev_a = 0
        prev_e = 0
        for k in range(4):
            ca = ac[3 * k] + 2 * ac[3 * k + 1] + 4 * ac[3 * k + 2]
            ce = ec[2 * k] + 2 * ec[2 * k + 1]
            b.when_transition().assert_zero(
                chain * (t1B[k] + s0B[k] + mj[k] + prev_a - ca * 256 - na[k])
            )
            b.when_transition().assert_zero(
                chain * (d_w[k] + t1B[k] + prev_e - ce * 256 - ne[k])
            )
            prev_a = ca
            prev_e = ce
        for dst, src in (("s_b", "s_a"), ("s_c", "s_b"), ("s_d", "s_c"),
                         ("s_f", "s_e"), ("s_g", "s_f"), ("s_h", "s_g")):
            for k in range(4):
                b.when_transition().assert_zero(
                    chain * (N.word(dst)[k] - L.word(src)[k])
                )

        # finalize on the last round row: h'[j] = h_init[j] + out_state[j],
        # written back at clk + 1; the write's prev is the h read at clk
        for j in range(8):
            eval_access(
                b, L, f"hw{j}", L["shard"], L["clk"] + 1, L["h_ptr"] + 4 * j,
                is_last, write=True,
            )
            for k in range(4):
                b.when(is_last).assert_eq(
                    L.word(f"hw{j}_prev_value")[k], L.word(f"hi_{j}")[k]
                )
            send_u8_word(b, L.word(f"hw{j}_value"), is_last)
        # j = 0 (a): h + s1 + ch + K + w + s0 + maj + hi == hw (byte adder,
        # reusing the t1B definition: t1B + s0 + mj + hi == hw)
        prev = 0
        for k in range(4):
            ca = ac[3 * k] + 2 * ac[3 * k + 1] + 4 * ac[3 * k + 2]
            b.when(is_last).assert_zero(
                t1B[k] + s0B[k] + mj[k] + L.word("hi_0")[k] + prev
                - L.word("hw0_value")[k] - ca * 256
            )
            prev = ca
        # j = 4 (e): d + t1 + hi == hw
        prev = 0
        for k in range(4):
            ce = ec[2 * k] + 2 * ec[2 * k + 1]
            b.when(is_last).assert_zero(
                d_w[k] + t1B[k] + L.word("hi_4")[k] + prev
                - L.word("hw4_value")[k] - ce * 256
            )
            prev = ce
        # the six shifted words: out + hi == hw with 1-bit carries
        wc = L["wc"]
        for t in range(24):
            b.assert_bool(wc[t])
        shifted = ["s_a", "s_b", "s_c", "s_e", "s_f", "s_g"]
        dests = [1, 2, 3, 5, 6, 7]
        for jj in range(6):
            prev = 0
            for k in range(4):
                c = wc[4 * jj + k]
                b.when(is_last).assert_zero(
                    L.word(shifted[jj])[k] + L.word(f"hi_{dests[jj]}")[k] + prev
                    - L.word(f"hw{dests[jj]}_value")[k] - c * 256
                )
                prev = c

    @staticmethod
    def _ror_xor(bits, j, rots):
        r1, r2, r3 = rots
        x = bits[(j + r1) % 32]
        y = bits[(j + r2) % 32]
        z = bits[(j + r3) % 32]
        return (
            x + y + z - 2 * (x * y) - 2 * (x * z) - 2 * (y * z) + 4 * ((x * y) * z)
        )

    def _xor3_bits(self, bits, j, rots):
        return self._ror_xor(bits, j, rots)
