"""U256xU2048MulChip: (hi, lo) = a * b with a 256-bit and b 2048-bit
(reference: crates/core/machine/src/syscall/precompiles/u256x2048_mul/).

One row per event. Exact integer identity over byte limbs:

    a(t) * b(t) - lo(t) - hi(t) * t^256  =  (t - 256) c(t)     at t = 256

with a = 32 limbs (from the a-reads), b = 256 limbs (b-reads), lo = 256
limbs (lo-writes), hi = 32 limbs (hi-writes) and a committed carry
polynomial of 287 limbs (two bytes each, offset 2^15; every coefficient
stays < 2^25, far below p). lo_ptr / hi_ptr come from traced register reads
of A2 / A3, exactly like the reference."""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import SyscallCode
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .field_gadget import C_OFF
from .layout import Layout, pack_word, trace_height, word_decompose_np
from .memory_access import add_access_cols, eval_access
from .weierstrass import _WeierstrassBase, _word_limbs

NA, NB = 32, 256  # byte limbs of a and b
NC = NA + NB - 1  # carry limbs (coefficients k = 0..NA+NB-1)

COLS = Layout().add("shard").add("clk").add("a_ptr").add("b_ptr").add("is_real")
add_access_cols(COLS, "lp", write=False)  # register A2 (lo_ptr)
add_access_cols(COLS, "hp", write=False)  # register A3 (hi_ptr)
for i in range(8):
    add_access_cols(COLS, f"ar{i}", write=False)
for i in range(64):
    add_access_cols(COLS, f"br{i}", write=False)
for i in range(64):
    add_access_cols(COLS, f"lw{i}", write=True)
for i in range(8):
    add_access_cols(COLS, f"hw{i}", write=True)
COLS.add("clo", NC).add("chi", NC)


class U256xU2048MulChip(_WeierstrassBase):
    picus_inputs = ("shard", "clk", "a_ptr", "b_ptr", "is_real")
    picus_outputs = ("clo", "chi")
    name = "U256xU2048Mul"
    SYSCALL = int(SyscallCode.U256XU2048_MUL)
    COLS = COLS
    width = COLS.width

    def generate_dependencies(self, record, output):
        for ev in self._events(record):
            clk = ev["clk"]
            self._deps_accesses(
                record, ev,
                [(clk, a) for a in ev["reads"]]
                + [(clk + 1, a) for a in ev["writes"]],
            )
            for _, _, _, _, value in ev["writes"]:
                wb = word_decompose_np(np.array([value], dtype=np.int64))
                count_u8_word(record, wb)
            _, carries = self._witness(ev)
            for c in carries:
                v = c + C_OFF
                count(record, B.U8Range, np.array([v & 0xFF]), v >> 8)

    @staticmethod
    def _witness(ev):
        a_words = [r[1] for r in ev["reads"][2:10]]
        b_words = [r[1] for r in ev["reads"][10:]]
        lo_words = [w[4] for w in ev["writes"][:64]]
        hi_words = [w[4] for w in ev["writes"][64:]]

        def limbs(words):
            out = []
            for w in words:
                out += [(int(w) >> (8 * k)) & 0xFF for k in range(4)]
            return out

        al, bl = limbs(a_words), limbs(b_words)
        ll, hl = limbs(lo_words), limbs(hi_words)
        e = [0] * (NC + 1)
        for i in range(NA):
            if al[i]:
                for j in range(NB):
                    e[i + j] += al[i] * bl[j]
        for k in range(NB):
            e[k] -= ll[k]
        for k in range(NA):
            e[NB + k] -= hl[k]
        carries, c_prev = [], 0
        for k in range(NC):
            tot = e[k] + c_prev
            assert tot % 256 == 0
            c = tot // 256
            assert -C_OFF <= c < C_OFF, c
            carries.append(c)
            c_prev = c
        assert e[NC] + c_prev == 0, "final carry nonzero"
        return e, carries

    def generate_trace(self, record, output):
        events = self._events(record)
        n = len(events)
        height = trace_height(n)
        mat = np.zeros((height, COLS.width), dtype=np.uint32)
        for r_i, ev in enumerate(events):
            row = mat[r_i]
            row[COLS.idx("shard")] = ev["shard"]
            row[COLS.idx("clk")] = ev["clk"]
            row[COLS.idx("a_ptr")] = ev["a_ptr"]
            row[COLS.idx("b_ptr")] = ev["b_ptr"]
            row[COLS.idx("is_real")] = 1
            _, carries = self._witness(ev)
            cw = np.array(carries) + C_OFF
            row[COLS.slc("clo")] = cw & 0xFF
            row[COLS.slc("chi")] = cw >> 8
            self._fill_access(row, COLS, "lp", ev["reads"][0], ev["clk"],
                              ev["shard"], False)
            self._fill_access(row, COLS, "hp", ev["reads"][1], ev["clk"],
                              ev["shard"], False)
            for i in range(8):
                self._fill_access(row, COLS, f"ar{i}", ev["reads"][2 + i],
                                  ev["clk"], ev["shard"], False)
            for i in range(64):
                self._fill_access(row, COLS, f"br{i}", ev["reads"][10 + i],
                                  ev["clk"], ev["shard"], False)
            for i in range(64):
                self._fill_access(row, COLS, f"lw{i}", ev["writes"][i],
                                  ev["clk"] + 1, ev["shard"], True)
            for i in range(8):
                self._fill_access(row, COLS, f"hw{i}", ev["writes"][64 + i],
                                  ev["clk"] + 1, ev["shard"], True)
        mat[n:, COLS.slc("clo")] = C_OFF & 0xFF
        mat[n:, COLS.slc("chi")] = C_OFF >> 8
        return mat

    def eval(self, b_):
        L = COLS.view(b_.main_local)
        is_real = L["is_real"]
        b_.assert_bool(is_real)
        b_.receive(
            LookupKind.Syscall,
            [L["shard"], L["clk"], self.SYSCALL, L["a_ptr"], L["b_ptr"]],
            is_real,
        )
        # pointer register reads (A2 = addr 6, A3 = addr 7)
        eval_access(b_, L, "lp", L["shard"], L["clk"], 6, is_real, write=False)
        eval_access(b_, L, "hp", L["shard"], L["clk"], 7, is_real, write=False)
        lo_ptr = pack_word(L.word("lp_value"))
        hi_ptr = pack_word(L.word("hp_value"))
        for i in range(8):
            eval_access(b_, L, f"ar{i}", L["shard"], L["clk"],
                        L["a_ptr"] + 4 * i, is_real, write=False)
        for i in range(64):
            eval_access(b_, L, f"br{i}", L["shard"], L["clk"],
                        L["b_ptr"] + 4 * i, is_real, write=False)
        for i in range(64):
            eval_access(b_, L, f"lw{i}", L["shard"], L["clk"] + 1,
                        lo_ptr + 4 * i, is_real, write=True)
            send_u8_word(b_, L.word(f"lw{i}_value"), is_real)
        for i in range(8):
            eval_access(b_, L, f"hw{i}", L["shard"], L["clk"] + 1,
                        hi_ptr + 4 * i, is_real, write=True)
            send_u8_word(b_, L.word(f"hw{i}_value"), is_real)
        al = _word_limbs(L, [f"ar{i}_value" for i in range(8)])
        bl = _word_limbs(L, [f"br{i}_value" for i in range(64)])
        ll = _word_limbs(L, [f"lw{i}_value" for i in range(64)])
        hl = _word_limbs(L, [f"hw{i}_value" for i in range(8)])
        clo, chi = L["clo"], L["chi"]
        for k in range(NC):
            send_byte(b_, B.U8Range, clo[k], chi[k], 0, is_real)
        carries = [clo[k] + chi[k] * 256 - C_OFF for k in range(NC)]
        for k in range(NC + 1):
            e = 0
            for i in range(max(0, k - NB + 1), min(NA, k + 1)):
                e = e + al[i] * bl[k - i]
            if k < NB:
                e = e - ll[k]
            else:
                e = e - hl[k - NB]
            c_prev = carries[k - 1] if k > 0 else 0
            c_cur = carries[k] if k < NC else 0
            b_.assert_zero(e + c_prev - c_cur * 256)
