"""Uint256MulChip: the UINT256_MUL precompile — one row per syscall,
result = x * y mod m (m == 0 means 2^256), written back to x_ptr
(reference: crates/core/machine/src/syscall/precompiles/uint256/air.rs).

Constraint core is a byte-limb polynomial identity (the moral equivalent of
the reference's FieldOpCols<U256Field>): with x, y, r as 32 byte limbs (from
the memory-access word bytes), q as a 33-limb witness quotient and m_eff the
modulus polynomial (m's 32 limbs, or t^32 when the modulus is zero),

    x(t) * y(t) - q(t) * m_eff(t) - r(t)  =  (t - 256) * c(t)

for a witness carry polynomial c with limbs offset by 2^15 and byte-range
checked (all per-coefficient equations stay < 2^25, far below p, so there is
no mod-p aliasing — the identity holds over the integers at t = 256).
A 32-byte lexicographic compare enforces r < m when m != 0 (reference
FieldLtCols / output_range_check).

Completeness bound: the quotient witness has 33 byte limbs, so proofs exist
only when x*y / m < 2^264 — i.e. the modulus is 0 (mod-2^256 semantics) or
roughly >= 2^248 (every cryptographic modulus in practice). The reference
has the same fixed-limb-count restriction in FieldOpCols.
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

NW = 8  # words per uint256
NL = 32  # byte limbs per uint256
NQ = 33  # quotient limbs (degree 32 reaches the t^32 modulus term)
NC = 63  # carry limbs c_0..c_62 (identity coefficients k = 0..63)
C_OFF = 1 << 15  # carry offset so witness limbs are non-negative

COLS = Layout().add("shard").add("clk").add("x_ptr").add("y_ptr")
for i in range(NW):
    add_access_cols(COLS, f"xw{i}", write=True)  # prev = x word, value = r word
for i in range(NW):
    add_access_cols(COLS, f"yr{i}", write=False)  # y words
for i in range(NW):
    add_access_cols(COLS, f"mr{i}", write=False)  # modulus words
COLS.add("q", NQ)
COLS.add("c_lo", NC).add("c_hi", NC)  # carry limbs + 2^15, two bytes each
COLS.add("m_inv")  # IsZero witness for the modulus byte sum
COLS.add("m_zero")  # 1 iff modulus == 0
COLS.add("df", NL)  # r < m compare: one-hot most-significant differing byte
COLS.add("sel_r").add("sel_m")  # the compared byte pair
COLS.add("is_real")


def _limbs_from_words(words):
    """8 u32 words (little-endian) -> 32 byte limbs, little-endian."""
    out = []
    for w in words:
        w = int(w)
        out += [(w >> (8 * k)) & 0xFF for k in range(4)]
    return out


def _witness(x_words, y_words, m_words):
    """Compute (r_words, q limbs, carry limbs) for one event."""
    to_int = lambda ws: sum(int(w) << (32 * i) for i, w in enumerate(ws))
    x_int, y_int, m_int = to_int(x_words), to_int(y_words), to_int(m_words)
    mod = m_int if m_int else (1 << 256)
    r_int = (x_int * y_int) % mod
    q_int = (x_int * y_int) // mod
    assert q_int < (1 << 264), "quotient exceeds 33 limbs"
    r_words = [(r_int >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    xl = _limbs_from_words(x_words)
    yl = _limbs_from_words(y_words)
    rl = _limbs_from_words(r_words)
    ql = [(q_int >> (8 * i)) & 0xFF for i in range(NQ)]
    if m_int:
        ml = _limbs_from_words(m_words) + [0]
    else:
        ml = [0] * 32 + [1]
    # per-coefficient residuals e_k, then carries: e_k + c_{k-1} = 256 c_k
    e = [0] * (NC + 1)
    for i in range(NL):
        for j in range(NL):
            e[i + j] += xl[i] * yl[j]
    for i in range(NQ):
        for j in range(NQ):
            if i + j <= NC:
                e[i + j] -= ql[i] * ml[j] if j < len(ml) else 0
    for k in range(NL):
        e[k] -= rl[k]
    carries = []
    c_prev = 0
    for k in range(NC):
        tot = e[k] + c_prev
        assert tot % 256 == 0, "carry recurrence broken"
        c = tot // 256
        assert -C_OFF <= c < C_OFF, f"carry {c} out of range"
        carries.append(c)
        c_prev = c
    assert e[NC] + c_prev == 0, "final carry nonzero"
    return r_words, ql, carries


class Uint256MulChip(Air):
    picus_inputs = ("shard", "clk", "x_ptr", "y_ptr", "is_real")
    picus_outputs = ("q", "c_lo", "c_hi", "m_inv", "m_zero", "df",
                     "sel_r", "sel_m")
    def num_rows(self, record):
        return len(self._events(record))

    name = "Uint256Mul"
    width = COLS.width

    def _events(self, record):
        return record.precompile_events.get(int(SyscallCode.UINT256_MUL), [])

    def included(self, record):
        return bool(self._events(record))

    def generate_dependencies(self, record, output):
        events = self._events(record)
        if not events:
            return
        for ev in events:
            clk, shard = ev["clk"], ev["shard"]
            for ts, accesses in ((clk, ev["reads"]), (clk + 1, ev["writes"])):
                for acc in accesses:
                    prev_clk, prev_shard = acc[2], acc[3]
                    compare = 1 if prev_shard == shard else 0
                    diff = (ts - prev_clk - 1) if compare else (shard - prev_shard - 1)
                    count(record, B.U16Range, np.array([diff & 0xFFFF]), 0)
                    count(record, B.U8Range, np.array([diff >> 16]), 0)
            for _, _, _, _, value in ev["writes"]:
                wb = word_decompose_np(np.array([value], dtype=np.int64))
                count_u8_word(record, wb)
            x_words = [wr[1] for wr in ev["writes"]]
            y_words = [rd[1] for rd in ev["reads"][:NW]]
            m_words = [rd[1] for rd in ev["reads"][NW:]]
            _r, ql, carries = self._wit(ev, x_words, y_words, m_words)
            for k in range(0, NQ - 1, 2):
                count(record, B.U8Range, np.array([ql[k]]), ql[k + 1])
            count(record, B.U8Range, np.array([ql[NQ - 1]]), 0)
            for c in carries:
                cw = c + C_OFF
                count(record, B.U8Range, np.array([cw & 0xFF]), cw >> 8)
            m_int = sum(int(w) << (32 * i) for i, w in enumerate(m_words))
            if m_int:
                rl = _limbs_from_words(_r)
                ml = _limbs_from_words(m_words)
                for k in range(NL - 1, -1, -1):
                    if rl[k] != ml[k]:
                        count(record, B.LTU, np.array([rl[k]]), ml[k])
                        break

    @staticmethod
    def _wit(ev, x_words, y_words, m_words):
        cache = ev.get("_wit")
        if cache is None:
            cache = _witness(x_words, y_words, m_words)
            ev["_wit"] = cache
        return cache

    def generate_trace(self, record, output):
        events = self._events(record)
        n = len(events)
        w = COLS.writer(n)
        if n:
            w.set("shard", [ev["shard"] for ev in events])
            w.set("clk", [ev["clk"] for ev in events])
            w.set("x_ptr", [ev["x_ptr"] for ev in events])
            w.set("y_ptr", [ev["y_ptr"] for ev in events])
            q = np.zeros((n, NQ), dtype=np.uint32)
            c_lo = np.zeros((n, NC), dtype=np.uint32)
            c_hi = np.zeros((n, NC), dtype=np.uint32)
            m_inv = np.zeros(n, dtype=np.uint32)
            m_zero = np.zeros(n, dtype=np.uint32)
            df = np.zeros((n, NL), dtype=np.uint32)
            sel_r = np.zeros(n, dtype=np.uint32)
            sel_m = np.zeros(n, dtype=np.uint32)
            P = 2130706433
            for r_i, ev in enumerate(events):
                x_words = [wr[1] for wr in ev["writes"]]
                y_words = [rd[1] for rd in ev["reads"][:NW]]
                m_words = [rd[1] for rd in ev["reads"][NW:]]
                r_words, ql, carries = self._wit(ev, x_words, y_words, m_words)
                assert r_words == [wr[4] for wr in ev["writes"]]
                q[r_i] = ql
                cw = np.array(carries) + C_OFF
                c_lo[r_i] = cw & 0xFF
                c_hi[r_i] = cw >> 8
                ml = _limbs_from_words(m_words)
                s = sum(ml)
                if s:
                    m_inv[r_i] = pow(s, P - 2, P)
                    rl = _limbs_from_words(r_words)
                    for k in range(NL - 1, -1, -1):
                        if rl[k] != ml[k]:
                            df[r_i, k] = 1
                            sel_r[r_i] = rl[k]
                            sel_m[r_i] = ml[k]
                            break
                    else:
                        raise AssertionError("r == m with nonzero modulus")
                else:
                    m_zero[r_i] = 1
            w.set("q", q)
            w.set("c_lo", c_lo)
            w.set("c_hi", c_hi)
            w.set("m_inv", m_inv)
            w.set("m_zero", m_zero)
            w.set("df", df)
            w.set("sel_r", sel_r)
            w.set("sel_m", sel_m)
            for i in range(NW):
                for prefix, rows, ts_off, write in (
                    (f"xw{i}", [ev["writes"][i] for ev in events], 1, True),
                    (f"yr{i}", [ev["reads"][i] for ev in events], 0, False),
                    (f"mr{i}", [ev["reads"][NW + i] for ev in events], 0, False),
                ):
                    rec_cols = {
                        "m_act": np.ones(n, dtype=np.int64),
                        "m_prev_value": np.array([r[1] for r in rows], dtype=np.int64),
                        "m_prev_clk": np.array([r[2] for r in rows], dtype=np.int64),
                        "m_prev_shard": np.array([r[3] for r in rows], dtype=np.int64),
                        "m_value": np.array(
                            [r[4] if write else r[1] for r in rows], dtype=np.int64
                        ),
                        "clk": np.array(
                            [ev["clk"] + ts_off for ev in events], dtype=np.int64
                        ),
                    }
                    fill_access(w, rec_cols, "m", prefix, 0, write=write,
                                shard=np.array([ev["shard"] for ev in events],
                                               dtype=np.int64))
            w.set("is_real", np.ones(n))
        mat = pad_to_pow2(w.mat)
        # padding: all limbs/q zero, carries at the offset, m_zero = 1 so the
        # ungated polynomial identity and IsZero gadget hold
        mat[n:, COLS.slc("c_lo")] = C_OFF & 0xFF
        mat[n:, COLS.slc("c_hi")] = C_OFF >> 8
        mat[n:, COLS.idx("m_zero")] = 1
        return mat

    def eval(self, b):
        L = COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        b.receive(
            LookupKind.Syscall,
            [L["shard"], L["clk"], int(SyscallCode.UINT256_MUL),
             L["x_ptr"], L["y_ptr"]],
            is_real,
        )
        # memory accesses: y + m reads at clk, x write at clk + 1
        for i in range(NW):
            eval_access(b, L, f"yr{i}", L["shard"], L["clk"],
                        L["y_ptr"] + 4 * i, is_real, write=False)
            eval_access(b, L, f"mr{i}", L["shard"], L["clk"],
                        L["y_ptr"] + 32 + 4 * i, is_real, write=False)
            eval_access(b, L, f"xw{i}", L["shard"], L["clk"] + 1,
                        L["x_ptr"] + 4 * i, is_real, write=True)
            send_u8_word(b, L.word(f"xw{i}_value"), is_real)

        xl = [L.word(f"xw{i}_prev_value")[k] for i in range(NW) for k in range(4)]
        yl = [L.word(f"yr{i}_value")[k] for i in range(NW) for k in range(4)]
        ml = [L.word(f"mr{i}_value")[k] for i in range(NW) for k in range(4)]
        rl = [L.word(f"xw{i}_value")[k] for i in range(NW) for k in range(4)]
        q = L["q"]
        z = L["m_zero"]

        # range checks: q limbs and carry limbs are bytes
        for k in range(0, NQ - 1, 2):
            send_byte(b, B.U8Range, q[k], q[k + 1], 0, is_real)
        send_byte(b, B.U8Range, q[NQ - 1], 0, 0, is_real)
        for k in range(NC):
            send_byte(b, B.U8Range, L["c_lo"][k], L["c_hi"][k], 0, is_real)
        # q's top limb is zero in the m == 0 case (so the t^64 coefficient of
        # q * m_eff vanishes; the identity below only covers k <= 63)
        b.assert_zero(q[NQ - 1] * z)

        # IsZero(modulus): z = 1 iff sum of modulus bytes is 0
        s = 0
        for k in range(NL):
            s = ml[k] + s
        b.assert_eq(z, 1 - s * L["m_inv"])
        b.assert_zero(s * z)

        # polynomial identity  x*y - q*m_eff - r = (t - 256) c  at each coeff
        # m_eff_j = m_j (1 - z) for j < 32, m_eff_32 = z
        carries = [
            L["c_lo"][k] + L["c_hi"][k] * 256 - C_OFF for k in range(NC)
        ]
        for k in range(NC + 1):
            e = 0
            for i in range(max(0, k - NL + 1), min(NL, k + 1)):
                e = e + xl[i] * yl[k - i]
            for i in range(max(0, k - NQ + 1), min(NQ, k + 1)):
                j = k - i
                if j < NL:
                    e = e - q[i] * ml[j] * (1 - z)
                elif j == NL:
                    e = e - q[i] * z
            if k < NL:
                e = e - rl[k]
            c_prev = carries[k - 1] if k > 0 else 0
            c_cur = carries[k] if k < NC else 0
            b.assert_zero(e + c_prev - c_cur * 256)

        # r < m when the modulus is nonzero (lexicographic, MSB first)
        df = L["df"]
        acc = 0
        for k in range(NL):
            b.assert_bool(df[k])
            acc = df[k] + acc
        b.assert_eq(acc, is_real * (1 - z))
        for k in range(NL):
            for j in range(k + 1, NL):
                b.assert_zero(df[k] * (ml[j] - rl[j]))
        b.assert_eq(L["sel_r"], sum(df[k] * rl[k] for k in range(NL)))
        b.assert_eq(L["sel_m"], sum(df[k] * ml[k] for k in range(NL)))
        send_byte(b, B.LTU, L["sel_r"], L["sel_m"], 1, is_real * (1 - z))
