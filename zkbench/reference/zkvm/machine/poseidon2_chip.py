"""Poseidon2PermuteChip: the poseidon2 precompile — one row per syscall,
full 22-round permutation in-row plus 16 read + 16 write memory accesses
(reference: crates/core/machine/src/syscall/precompiles/poseidon2/ with the
round gadget from operations/poseidon2/air.rs).

State columns hold the canonical field value after each round; every round
transition is a single degree-3 constraint (sbox folded into the linear
layer). Memory words pack to the field values; outputs are range-checked
< 2^31 via an MSB lookup so the byte decomposition is unique.
"""

from __future__ import annotations

import numpy as np

from ..core import field as F
from ..core import poseidon2 as p2
from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import SyscallCode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .layout import Layout, pack_word, pad_to_pow2, word_decompose_np
from .memory_access import add_access_cols, eval_access, fill_access

NUM_ROUNDS = 21  # 4 + 13 + 4 (plus the initial linear layer)
M_EXT = p2._build_external_matrix().T.astype(np.int64)  # [i][j] coefficient
RC = p2.RC.astype(np.int64)
DIAG = p2.INTERNAL_DIAG.astype(np.int64)

COLS = Layout().add("shard").add("clk").add("ptr").add("arg2")
for r in range(NUM_ROUNDS + 2):  # s0 = input fields, s1 = after init layer,
    COLS.add(f"s{r}", 16)  # s2..s22 = after each round
for i in range(16):
    add_access_cols(COLS, f"rd{i}", write=False)
for i in range(16):
    add_access_cols(COLS, f"wr{i}", write=True)
COLS.add("is_real")


_ZERO_CHAIN = None


def _zero_chain():
    global _ZERO_CHAIN
    if _ZERO_CHAIN is None:
        states = [np.zeros(16, dtype=np.int64)]
        cur = Poseidon2PermuteChip._apply_ext_layer(states[0])
        states.append(cur)
        for r in range(4):
            cur = Poseidon2PermuteChip._apply_ext_layer(
                Poseidon2PermuteChip._sbox_all(cur + RC[r])
            )
            states.append(cur)
        for r in range(13):
            t = cur.copy()
            t[0] = Poseidon2PermuteChip._sbox(cur[0] + RC[4 + r][0])
            cur = (DIAG * t + t.sum() % F.P_INT) % F.P_INT
            states.append(cur)
        for r in range(4):
            cur = Poseidon2PermuteChip._apply_ext_layer(
                Poseidon2PermuteChip._sbox_all(cur + RC[17 + r])
            )
            states.append(cur)
        _ZERO_CHAIN = [np.asarray(s_, dtype=np.int64) % F.P_INT for s_ in states]
    return _ZERO_CHAIN


class Poseidon2PermuteChip(Air):
    picus_inputs = ("shard", "clk", "ptr", "arg2", "s0", "is_real")
    picus_outputs = tuple(f"s{r}" for r in range(1, 23))
    name = "Poseidon2Permute"
    width = COLS.width

    def _events(self, record):
        from ..executor.precompile_mem import group_events

        group_events(record)  # annotate events with dispatch args
        return record.precompile_events.get(int(SyscallCode.POSEIDON2_PERMUTE), [])

    def included(self, record):
        return bool(self._events(record))

    def num_rows(self, record):
        return len(self._events(record))

    def generate_dependencies(self, record, output):
        events = self._events(record)
        if not events:
            return
        for ev in events:
            clk, shard = ev["clk"], ev["shard"]  # shard == record's shard
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
                count(record, B.MSB, wb[:, 3], 0)

    def generate_trace(self, record, output):
        events = self._events(record)
        n = len(events)
        w = COLS.writer(n)
        if n:
            w.set("shard", [ev["shard"] for ev in events])
            w.set("clk", [ev["clk"] for ev in events])
            w.set("ptr", [ev["ptr"] for ev in events])
            w.set("arg2", [ev["_arg2"] % F.P_INT for ev in events])
            states = np.zeros((n, NUM_ROUNDS + 2, 16), dtype=np.int64)
            for r_i, ev in enumerate(events):
                s = np.array([rd[1] for rd in ev["reads"]], dtype=np.int64)
                states[r_i, 0] = s
                states[r_i, 1] = self._apply_ext_layer(s)
                cur = states[r_i, 1]
                for r in range(4):
                    cur = self._apply_ext_layer(self._sbox_all(cur + RC[r]))
                    states[r_i, 2 + r] = cur
                for r in range(13):
                    t = cur.copy()
                    t[0] = self._sbox(cur[0] + RC[4 + r][0])
                    cur = (DIAG * t + t.sum() % F.P_INT) % F.P_INT
                    states[r_i, 6 + r] = cur
                for r in range(4):
                    cur = self._apply_ext_layer(self._sbox_all(cur + RC[17 + r]))
                    states[r_i, 19 + r] = cur
                assert np.array_equal(
                    cur % F.P_INT,
                    np.array([wr[4] for wr in ev["writes"]], dtype=np.int64),
                ), "poseidon2 trace mismatch"
            for r in range(NUM_ROUNDS + 2):
                w.set(f"s{r}", states[:, r] % F.P_INT)
            # memory access cols
            for i in range(16):
                for prefix, key, ts_off, write in (
                    (f"rd{i}", "reads", 0, False),
                    (f"wr{i}", "writes", 1, True),
                ):
                    rows = [ev[key][i] for ev in events]
                    rec_cols = {
                        f"m_act": np.ones(n, dtype=np.int64),
                        f"m_prev_value": np.array([r[1] for r in rows], dtype=np.int64),
                        f"m_prev_clk": np.array([r[2] for r in rows], dtype=np.int64),
                        f"m_prev_shard": np.array([r[3] for r in rows], dtype=np.int64),
                        f"m_value": np.array(
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
        # padding rows must satisfy the (ungated) round constraints: fill
        # them with the permutation chain of the zero state
        chain = _zero_chain()
        for r in range(NUM_ROUNDS + 2):
            mat[n:, COLS.slc(f"s{r}")] = chain[r]
        return mat

    @staticmethod
    def _sbox(x):
        x = int(x) % F.P_INT
        return (x * x % F.P_INT) * x % F.P_INT

    @staticmethod
    def _sbox_all(v):
        v = v % F.P_INT
        return (v * v % F.P_INT) * v % F.P_INT

    @staticmethod
    def _apply_ext_layer(s):
        return (M_EXT.astype(object) @ (s % F.P_INT)) % F.P_INT

    def eval(self, b):
        L = COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        # dispatch from the SyscallPrecompile bridge (canonical 5-element
        # message; arg2 is the unused c operand, bound only by the lookup)
        b.receive(
            LookupKind.Syscall,
            [L["shard"], L["clk"], int(SyscallCode.POSEIDON2_PERMUTE),
             L["ptr"], L["arg2"]],
            is_real,
        )
        # memory reads at clk bind the input state
        s0 = L[f"s{0}"]
        for i in range(16):
            eval_access(
                b, L, f"rd{i}", L["shard"], L["clk"], L["ptr"] + 4 * i,
                is_real, write=False,
            )
            b.when(is_real).assert_eq(
                s0[i], pack_word(L.word(f"rd{i}_value"))
            )
        # rounds
        self._eval_rounds(b, L, is_real)
        # memory writes at clk + 1 bind the output state
        s_out = L[f"s{NUM_ROUNDS + 1}"]
        for i in range(16):
            eval_access(
                b, L, f"wr{i}", L["shard"], L["clk"] + 1, L["ptr"] + 4 * i,
                is_real, write=True,
            )
            wv = L.word(f"wr{i}_value")
            b.when(is_real).assert_eq(s_out[i], pack_word(wv))
            send_u8_word(b, wv, is_real)
            # top byte < 128 so the decomposition of the field value is unique
            send_byte(b, B.MSB, wv[3], 0, 0, is_real)
            # the written prev value must equal the read value (same word)
            for j in range(4):
                b.when(is_real).assert_eq(
                    L.word(f"wr{i}_prev_value")[j], L.word(f"rd{i}_value")[j]
                )

    def _eval_rounds(self, b, L, is_real):
        def ext_round(cur, nxt, rc_row):
            sboxed = []
            for j in range(16):
                x = cur[j] + int(rc_row[j]) if rc_row is not None else cur[j]
                sboxed.append(x * x * x if rc_row is not None else x)
            for i in range(16):
                expr = 0
                for j in range(16):
                    coef = int(M_EXT[i][j])
                    if coef:
                        expr = sboxed[j] * coef + expr
                b.assert_eq(nxt[i], expr)

        # initial linear layer (no sbox)
        ext_round(L["s0"], L["s1"], None)
        cur = 1
        for r in range(4):
            ext_round(L[f"s{cur}"], L[f"s{cur + 1}"], RC[r])
            cur += 1
        for r in range(13):
            c_cols = L[f"s{cur}"]
            n_cols = L[f"s{cur + 1}"]
            x0 = c_cols[0] + int(RC[4 + r][0])
            t0 = x0 * x0 * x0
            total = t0
            for j in range(1, 16):
                total = total + c_cols[j]
            for i in range(16):
                ti = t0 if i == 0 else c_cols[i]
                b.assert_eq(n_cols[i], ti * int(DIAG[i]) + total)
            cur += 1
        for r in range(4):
            ext_round(L[f"s{cur}"], L[f"s{cur + 1}"], RC[17 + r])
            cur += 1
