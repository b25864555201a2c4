"""ShaExtendChip: the SHA-256 message-schedule extension precompile
(reference: crates/core/machine/src/syscall/precompiles/sha256/extend).

One row per iteration i in [16, 64): reads w[i-16], w[i-15], w[i-7], w[i-2]
and writes w[i] = w[i-16] + s0 + w[i-7] + s1 (mod 2^32) at clk + (i - 16),
where s0 = ror7(x) ^ ror18(x) ^ shr3(x) and s1 = ror17(y) ^ ror19(y) ^
shr10(y). The sigma functions are evaluated as degree-3 bit expressions over
the bit decompositions of w[i-15] / w[i-2]; rows of one syscall chain
(ptr/clk/i increment) and the first row receives the dispatch lookup.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import SyscallCode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .layout import Layout, pack_word, pad_to_pow2, word_decompose_np
from .memory_access import add_access_cols, eval_access, fill_access

P = 2130706433

COLS = Layout().add("shard").add("clk").add("ptr").add("arg2").add("i")
COLS.add("is_first").add("is_last").add("i63_inv")
COLS.add("b15", 32)  # bits of w[i-15]
COLS.add("b2", 32)  # bits of w[i-2]
COLS.add("sum_carry", 12)  # per-byte carries of the 4-term adder (3 bits each)
for nm in ("r16", "r15", "r7", "r2"):
    add_access_cols(COLS, nm, write=False)
add_access_cols(COLS, "wr", write=True)
COLS.add("is_real")

READ_OFFSETS = {"r16": -16, "r15": -15, "r7": -7, "r2": -2}


def _xor3(x, y, z):
    """Degree-3 expression for x ^ y ^ z over boolean values."""
    return x + y + z - 2 * (x * y) - 2 * (x * z) - 2 * (y * z) + 4 * ((x * y) * z)


def _sigma_bits(bits, r1, r2, shift):
    """Per-output-bit expressions of ror(x,r1) ^ ror(x,r2) ^ shr(x,shift)."""
    out = []
    for j in range(32):
        a = bits[(j + r1) % 32]
        b = bits[(j + r2) % 32]
        c = bits[j + shift] if j + shift < 32 else None
        if c is None:
            out.append(a + b - 2 * (a * b))
        else:
            out.append(_xor3(a, b, c))
    return out


class ShaExtendChip(Air):
    picus_inputs = ("shard", "clk", "ptr", "arg2", "i", "is_real")
    picus_outputs = ("is_first", "is_last", "i63_inv", "b15", "b2",
                     "sum_carry")
    name = "ShaExtend"
    width = COLS.width

    def _events(self, record):
        from ..executor.precompile_mem import group_events

        group_events(record)  # annotate events with dispatch args
        return record.precompile_events.get(int(SyscallCode.SHA_EXTEND), [])

    def included(self, record):
        return bool(self._events(record))

    def num_rows(self, record):
        return len(self._events(record))

    def generate_dependencies(self, record, output):
        events = self._events(record)
        if not events:
            return
        from itertools import chain

        # every event's four reads (addr, value, prev_clk, prev_shard) and its
        # write (addr, prev_value, prev_clk, prev_shard, value)
        n = len(events)
        reads = np.fromiter(chain.from_iterable(chain.from_iterable(
            ev["reads"] for ev in events)), np.int64, 16 * n).reshape(n, 4, 4)
        write = np.array([ev["write"] for ev in events], dtype=np.int64)
        acc = np.concatenate([reads, write[:, None, :4]], axis=1)
        clk = np.array([ev["clk"] for ev in events], dtype=np.int64)[:, None]
        shard = np.array([ev["shard"] for ev in events], dtype=np.int64)[:, None]
        prev_clk, prev_shard = acc[..., 2], acc[..., 3]
        diff = np.where(prev_shard == shard, clk - prev_clk - 1, shard - prev_shard - 1)
        count(record, B.U16Range, diff & 0xFFFF, 0)
        count(record, B.U8Range, diff >> 16, 0)
        count_u8_word(record, word_decompose_np(write[:, 4]))

    def generate_trace(self, record, output):
        events = self._events(record)
        n = len(events)
        w = COLS.writer(n)
        if n:
            w.set("shard", [ev["shard"] for ev in events])
            w.set("clk", [ev["clk"] for ev in events])
            w.set("ptr", [ev["ptr"] for ev in events])
            w.set("arg2", [ev["_arg2"] % P for ev in events])
            iv = np.array([ev["i"] for ev in events], dtype=np.int64)
            w.set("i", iv)
            w.set("is_first", (iv == 16).astype(np.uint32))
            w.set("is_last", (iv == 63).astype(np.uint32))
            from ..core.field import finv

            w.set("i63_inv", finv(((iv - 63) % P).astype(np.uint32)))
            w15 = np.array([ev["reads"][1][1] for ev in events], dtype=np.int64)
            w2 = np.array([ev["reads"][3][1] for ev in events], dtype=np.int64)
            b15 = np.zeros((n, 32), dtype=np.uint32)
            b2 = np.zeros((n, 32), dtype=np.uint32)
            for j in range(32):
                b15[:, j] = (w15 >> j) & 1
                b2[:, j] = (w2 >> j) & 1
            w.set("b15", b15)
            w.set("b2", b2)
            ror = lambda x, r: ((x >> r) | (x << (32 - r))) & 0xFFFFFFFF
            s0 = np.array(
                [ror(int(x), 7) ^ ror(int(x), 18) ^ (int(x) >> 3) for x in w15],
                dtype=np.int64,
            )
            s1 = np.array(
                [ror(int(x), 17) ^ ror(int(x), 19) ^ (int(x) >> 10) for x in w2],
                dtype=np.int64,
            )
            w16 = np.array([ev["reads"][0][1] for ev in events], dtype=np.int64)
            w7 = np.array([ev["reads"][2][1] for ev in events], dtype=np.int64)
            # per-byte carries of w16 + s0 + w7 + s1
            carries = np.zeros((n, 12), dtype=np.uint32)
            cur = np.zeros(n, dtype=np.int64)
            for k in range(4):
                bs = (
                    ((w16 >> (8 * k)) & 0xFF) + ((s0 >> (8 * k)) & 0xFF)
                    + ((w7 >> (8 * k)) & 0xFF) + ((s1 >> (8 * k)) & 0xFF) + cur
                )
                cur = bs >> 8
                for t in range(3):
                    carries[:, 3 * k + t] = ((cur >> t) & 1).astype(np.uint32)
            w.set("sum_carry", carries)
            shard = np.array([ev["shard"] for ev in events], dtype=np.int64)
            for nm, ridx in (("r16", 0), ("r15", 1), ("r7", 2), ("r2", 3)):
                rows = [ev["reads"][ridx] for ev in events]
                rc = {
                    "m_act": np.ones(n, dtype=np.int64),
                    "m_prev_value": np.array([r[1] for r in rows], dtype=np.int64),
                    "m_prev_clk": np.array([r[2] for r in rows], dtype=np.int64),
                    "m_prev_shard": np.array([r[3] for r in rows], dtype=np.int64),
                    "m_value": np.array([r[1] for r in rows], dtype=np.int64),
                    "clk": np.array([ev["clk"] for ev in events], dtype=np.int64),
                }
                fill_access(w, rc, "m", nm, 0, write=False, shard=shard)
            rows = [ev["write"] for ev in events]
            rc = {
                "m_act": np.ones(n, dtype=np.int64),
                "m_prev_value": np.array([r[1] for r in rows], dtype=np.int64),
                "m_prev_clk": np.array([r[2] for r in rows], dtype=np.int64),
                "m_prev_shard": np.array([r[3] for r in rows], dtype=np.int64),
                "m_value": np.array([r[4] for r in rows], dtype=np.int64),
                "clk": np.array([ev["clk"] for ev in events], dtype=np.int64),
            }
            fill_access(w, rc, "m", "wr", 0, write=True, shard=shard)
            w.set("is_real", np.ones(n))
        mat = pad_to_pow2(w.mat)
        # padding: i63_inv = inv(0 - 63) so the not-last constraint holds
        mat[n:, COLS.idx("i63_inv")] = pow((0 - 63) % P, P - 2, P)
        return mat

    def eval(self, b):
        L = COLS.view(b.main_local)
        N = COLS.view(b.main_next)
        is_real = L["is_real"]
        is_first, is_last = L["is_first"], L["is_last"]
        b.assert_bool(is_real)
        b.assert_bool(is_first)
        b.assert_bool(is_last)
        b.when_first_row().when(is_real).assert_one(is_first)
        b.when_transition().assert_zero(N["is_real"] * (1 - is_real))

        # dispatch on the first iteration row (canonical 5-element message
        # from the SyscallPrecompile bridge; arg2 = unused c operand)
        b.receive(
            LookupKind.Syscall,
            [L["shard"], L["clk"], int(SyscallCode.SHA_EXTEND), L["ptr"],
             L["arg2"]],
            is_first,
        )
        b.when(is_first).assert_eq(L["i"], 16)
        b.when(is_last).assert_eq(L["i"], 63)
        # i != 63 whenever not last (padding rows carry inv(-63))
        b.assert_zero((1 - is_last) * ((L["i"] - 63) * L["i63_inv"] - 1))
        # chain within an event
        chain = is_real * (1 - is_last)
        b.when_transition().assert_zero(chain * (1 - N["is_real"]))
        b.when_transition().when(chain).assert_eq(N["i"], L["i"] + 1)
        b.when_transition().when(chain).assert_eq(N["ptr"], L["ptr"])
        b.when_transition().when(chain).assert_eq(N["clk"], L["clk"] + 1)
        b.when_transition().when(chain).assert_eq(N["shard"], L["shard"])
        b.when_transition().when(chain).assert_zero(N["is_first"])
        # after a last iteration, a real next row starts a new event
        b.when_transition().when(is_last * N["is_real"]).assert_one(N["is_first"])
        b.when_last_row().when(is_real).assert_one(is_last)

        # memory accesses at this iteration's clk
        for nm, off in READ_OFFSETS.items():
            eval_access(
                b, L, nm, L["shard"], L["clk"], L["ptr"] + 4 * (L["i"] + off),
                is_real, write=False,
            )
        eval_access(
            b, L, "wr", L["shard"], L["clk"], L["ptr"] + 4 * L["i"],
            is_real, write=True,
        )

        # bit decompositions of w[i-15] and w[i-2]; bits are bound to the
        # memory-word BYTES per byte (exact integer equations < 2^8, immune
        # to mod-p aliasing)
        b15, b2 = L["b15"], L["b2"]
        for j in range(32):
            b.assert_bool(b15[j])
            b.assert_bool(b2[j])
        byte_of = lambda bits, k: sum(bits[8 * k + t] * (1 << t) for t in range(8))
        for k in range(4):
            b.assert_eq(byte_of(b15, k), L.word("r15_value")[k])
            b.assert_eq(byte_of(b2, k), L.word("r2_value")[k])

        # w[i] = w[i-16] + s0 + w[i-7] + s1 (mod 2^32): byte-level adder
        # (each equation sums values < 2^11, exact over the integers)
        s0 = _sigma_bits(b15, 7, 18, 3)
        s1 = _sigma_bits(b2, 17, 19, 10)
        sc = L["sum_carry"]
        for j in range(12):
            b.assert_bool(sc[j])
        prev = 0
        for k in range(4):
            carry_k = sc[3 * k] + 2 * sc[3 * k + 1] + 4 * sc[3 * k + 2]
            b.assert_zero(
                L.word("r16_value")[k]
                + byte_of(s0, k)
                + L.word("r7_value")[k]
                + byte_of(s1, k)
                + prev
                - L.word("wr_value")[k]
                - carry_k * 256
            )
            prev = carry_k
        send_u8_word(b, L.word("wr_value"), is_real)
