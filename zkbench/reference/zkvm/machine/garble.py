"""BooleanCircuitGarbleChip: one row per gate
(reference: crates/core/machine/src/syscall/precompiles/boolean_circuit/ —
the garbled-circuit ciphertext check; bit-plane layout after keccak_sponge).

Gate row: 17 word reads (type, h0[4], h1[4], label[4], expected_ct[4]) at
input_ptr + 20 + 68*gate_idx. Committed bit planes h0/h1/label/delta (128
bits each, bound to the access bytes), the xor chain

    x1 = h0 ^ h1      x2 = x1 ^ label      ct = x2 ^ (is_or & delta)

with ct committed so the byte comparison against expected stays degree-2.
Per-gate `ok` carries an equality proof (ok = 1: all 16 bytes equal;
ok = 0: a one-hot selected byte differs, witnessed by an inverse). The
result chains down the event (res_out = res_in * ok) and the final row
writes it to output_ptr. The first row additionally reads num_gates and the
four delta words at input_ptr; shard/clk/ptrs/num_gates/delta bytes are
copied down the event.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import SyscallCode
from ..stark.lookup import LookupKind
from .byte import count
from .layout import Layout, trace_height, word_decompose_np
from .memory_access import add_access_cols, eval_access
from .weierstrass import _WeierstrassBase

NW = 17  # words per gate

COLS = Layout().add("shard").add("clk").add("input_ptr").add("output_ptr")
COLS.add("num_gates").add("gate_idx")
COLS.add("is_real").add("ev_start").add("is_last").add("cont_next")
COLS.add("res_in").add("res_out").add("ok")
COLS.add("is_or").add("or_inv")  # gate type != 0
add_access_cols(COLS, "ng", write=False)  # num_gates read (first row)
for i in range(4):
    add_access_cols(COLS, f"dr{i}", write=False)  # delta reads (first row)
for i in range(NW):
    add_access_cols(COLS, f"gr{i}", write=False)  # gate words (every row)
add_access_cols(COLS, "ow", write=True)  # output write (last row)
COLS.add("delta_b", 16)  # delta bytes, copied down the event
for nm in ("h0b", "h1b", "lbb", "dlb", "x1b", "x2b", "ctb"):
    COLS.add(nm, 128)
COLS.add("df", 16).add("sel_c").add("sel_e").add("dinv")


def _bits_of_words(words4):
    out = np.zeros(128, dtype=np.uint32)
    for i, w in enumerate(words4):
        for z in range(32):
            out[32 * i + z] = (int(w) >> z) & 1
    return out


class BooleanCircuitGarbleChip(_WeierstrassBase):
    picus_inputs = ("shard", "clk", "input_ptr", "output_ptr",
                    "num_gates", "gate_idx", "is_real", "ev_start")
    picus_outputs = ("is_last", "cont_next", "res_in", "res_out", "ok",
                     "is_or", "or_inv", "delta_b", "df", "sel_c", "sel_e",
                     "dinv")
    def num_rows(self, record):
        return sum(
            max(1, (len(e["reads"]) - 5) // NW)
            for e in self._events(record)
        )

    name = "BooleanCircuitGarble"
    SYSCALL = int(SyscallCode.BOOLEAN_CIRCUIT_GARBLE)
    COLS = COLS
    width = COLS.width

    def _events(self, record):
        return record.precompile_events.get(
            int(SyscallCode.BOOLEAN_CIRCUIT_GARBLE), []
        )

    def generate_dependencies(self, record, output):
        for ev in self._events(record):
            clk = ev["clk"]
            self._deps_accesses(
                record, ev,
                [(clk, a) for a in ev["reads"]] + [(clk, a) for a in ev["writes"]],
            )

    def generate_trace(self, record, output):
        events = self._events(record)
        n_real = sum(max(1, (len(e["reads"]) - 5) // NW) for e in events)
        height = trace_height(n_real)
        mat = np.zeros((height, COLS.width), dtype=np.uint32)
        row = 0
        for ev in events:
            ng = (len(ev["reads"]) - 5) // NW
            assert ng >= 1, "zero-gate garble events unsupported in-circuit"
            delta_words = [r[1] for r in ev["reads"][1:5]]
            dlb = _bits_of_words(delta_words)
            db16 = np.concatenate(
                [word_decompose_np(np.array([w], dtype=np.int64))[0]
                 for w in delta_words]
            )
            res = 1
            for g in range(ng):
                r = mat[row]
                r[COLS.idx("shard")] = ev["shard"]
                r[COLS.idx("clk")] = ev["clk"]
                r[COLS.idx("input_ptr")] = ev["input_ptr"]
                r[COLS.idx("output_ptr")] = ev["output_ptr"]
                r[COLS.idx("num_gates")] = ng
                r[COLS.idx("gate_idx")] = g
                r[COLS.idx("is_real")] = 1
                r[COLS.idx("ev_start")] = int(g == 0)
                r[COLS.idx("is_last")] = int(g == ng - 1)
                r[COLS.idx("cont_next")] = int(g < ng - 1)
                r[COLS.slc("delta_b")] = db16
                r[COLS.slc("dlb")] = dlb
                gw = [rd[1] for rd in ev["reads"][5 + NW * g : 5 + NW * (g + 1)]]
                gtype, h0, h1, lb = gw[0], gw[1:5], gw[5:9], gw[9:13]
                exp = gw[13:17]
                is_or = int(gtype != 0)
                r[COLS.idx("is_or")] = is_or
                if is_or:
                    P = 2130706433
                    s = sum((gtype >> (8 * k)) & 0xFF for k in range(4)) % P
                    r[COLS.idx("or_inv")] = pow(s, P - 2, P)
                h0b, h1b, lbb = (_bits_of_words(v) for v in (h0, h1, lb))
                x1b = h0b ^ h1b
                x2b = x1b ^ lbb
                ctb = x2b ^ (dlb if is_or else 0)
                for nm, v in (("h0b", h0b), ("h1b", h1b), ("lbb", lbb),
                              ("x1b", x1b), ("x2b", x2b), ("ctb", ctb)):
                    r[COLS.slc(nm)] = v
                ct_bytes = [
                    int(sum(int(ctb[8 * j + k]) << k for k in range(8)))
                    for j in range(16)
                ]
                exp_bytes = np.concatenate(
                    [word_decompose_np(np.array([w], dtype=np.int64))[0]
                     for w in exp]
                )
                ok = int(all(ct_bytes[j] == exp_bytes[j] for j in range(16)))
                r[COLS.idx("ok")] = ok
                if not ok:
                    for j in range(16):
                        if ct_bytes[j] != exp_bytes[j]:
                            r[COLS.slc("df")][j] = 1
                            r[COLS.idx("sel_c")] = ct_bytes[j]
                            r[COLS.idx("sel_e")] = exp_bytes[j]
                            P = 2130706433
                            r[COLS.idx("dinv")] = pow(
                                int(ct_bytes[j] - int(exp_bytes[j])) % P,
                                P - 2, P,
                            )
                            break
                r[COLS.idx("res_in")] = res
                res = res * ok
                r[COLS.idx("res_out")] = res
                if g == 0:
                    self._fill_access(r, COLS, "ng", ev["reads"][0],
                                      ev["clk"], ev["shard"], False)
                    for i in range(4):
                        self._fill_access(r, COLS, f"dr{i}", ev["reads"][1 + i],
                                          ev["clk"], ev["shard"], False)
                for i in range(NW):
                    self._fill_access(r, COLS, f"gr{i}",
                                      ev["reads"][5 + NW * g + i],
                                      ev["clk"], ev["shard"], False)
                if g == ng - 1:
                    self._fill_access(r, COLS, "ow", ev["writes"][0],
                                      ev["clk"], ev["shard"], True)
                row += 1
        return mat

    def eval(self, b_):
        C = COLS
        L = C.view(b_.main_local)
        N = C.view(b_.main_next)
        is_real = L["is_real"]
        ev_start = L["ev_start"]
        is_last = L["is_last"]
        cont = L["cont_next"]
        for f in (is_real, ev_start, is_last, cont):
            b_.assert_bool(f)
        b_.assert_eq(cont, is_real - is_last * is_real)
        b_.assert_zero(is_last * (1 - is_real))
        # event chaining (same pattern as the keccak sponge)
        b_.assert_zero(ev_start * (1 - is_real))
        b_.assert_zero(ev_start * L["gate_idx"])
        b_.when_first_row().assert_zero(is_real * (1 - ev_start))
        b_.when_transition().assert_zero(cont * N["ev_start"])
        b_.when_transition().assert_zero(
            N["is_real"] * (1 - cont) * (1 - N["ev_start"])
        )
        for nm in ("shard", "clk", "input_ptr", "output_ptr", "num_gates"):
            b_.when_transition().assert_zero(cont * (N[nm] - L[nm]))
        b_.when_transition().assert_zero(
            cont * (N["gate_idx"] - L["gate_idx"] - 1)
        )
        b_.assert_zero(is_last * (L["num_gates"] - L["gate_idx"] - 1))
        db = L["delta_b"]
        for j in range(16):
            b_.when_transition().assert_zero(cont * (N["delta_b"][j] - db[j]))

        # dispatch + first-row reads
        b_.receive(
            LookupKind.Syscall,
            [L["shard"], L["clk"], self.SYSCALL,
             L["input_ptr"], L["output_ptr"]],
            ev_start,
        )
        eval_access(b_, L, "ng", L["shard"], L["clk"], L["input_ptr"],
                    ev_start, write=False)
        ngv = L.word("ng_value")
        b_.assert_zero(ev_start * (L["num_gates"]
                                   - ngv[0] - 256 * ngv[1] - 65536 * ngv[2]))
        b_.assert_zero(ev_start * ngv[3])
        for i in range(4):
            eval_access(b_, L, f"dr{i}", L["shard"], L["clk"],
                        L["input_ptr"] + 4 + 4 * i, ev_start, write=False)
            dv = L.word(f"dr{i}_value")
            for j in range(4):
                b_.assert_zero(ev_start * (db[4 * i + j] - dv[j]))
        # gate reads at input_ptr + 20 + 68 * gate_idx
        base = L["input_ptr"] + 20 + 68 * L["gate_idx"]
        for i in range(NW):
            eval_access(b_, L, f"gr{i}", L["shard"], L["clk"],
                        base + 4 * i, is_real, write=False)

        # gate type flag: is_or = (type word != 0), via byte-sum inverse
        tv = L.word("gr0_value")
        t_sum = tv[0] + tv[1] + tv[2] + tv[3]
        is_or = L["is_or"]
        b_.assert_bool(is_or)
        b_.assert_zero(is_real * (is_or - t_sum * L["or_inv"]))
        b_.assert_zero(t_sum * (1 - is_or))

        # bit planes bound to the access bytes
        def bind_bits(nm, word_names):
            bits = L[nm]
            for i in range(128):
                b_.assert_bool(bits[i])
            for wi, wnm in enumerate(word_names):
                wv = L.word(wnm)
                for j in range(4):
                    byte = 0
                    for k in range(8):
                        byte = bits[32 * wi + 8 * j + k] * (1 << k) + byte
                    b_.assert_zero(is_real * (wv[j] - byte))
            return bits

        h0b = bind_bits("h0b", [f"gr{i}_value" for i in range(1, 5)])
        h1b = bind_bits("h1b", [f"gr{i}_value" for i in range(5, 9)])
        lbb = bind_bits("lbb", [f"gr{i}_value" for i in range(9, 13)])
        dlb = L["dlb"]
        for i in range(128):
            b_.assert_bool(dlb[i])
        for j in range(16):
            byte = 0
            for k in range(8):
                byte = dlb[8 * j + k] * (1 << k) + byte
            b_.assert_zero(is_real * (db[j] - byte))
        # xor chain
        x1b, x2b, ctb = L["x1b"], L["x2b"], L["ctb"]
        for i in range(128):
            b_.assert_eq(x1b[i], h0b[i] + h1b[i] - 2 * h0b[i] * h1b[i])
            b_.assert_eq(x2b[i], x1b[i] + lbb[i] - 2 * x1b[i] * lbb[i])
            gd = is_or * dlb[i]
            # ungated (degree 3); padding rows are all-zero and satisfy it
            b_.assert_zero(ctb[i] - (x2b[i] + gd - 2 * x2b[i] * gd))
            b_.assert_bool(ctb[i])

        # byte comparison against expected (gr13..gr16)
        exp_bytes = []
        for i in range(13, 17):
            exp_bytes += list(L.word(f"gr{i}_value"))
        ok = L["ok"]
        b_.assert_bool(ok)
        ct_bytes = []
        for j in range(16):
            byte = 0
            for k in range(8):
                byte = ctb[8 * j + k] * (1 << k) + byte
            ct_bytes.append(byte)
            b_.assert_zero(ok * (byte - exp_bytes[j]))
        df = L["df"]
        dacc = 0
        for j in range(16):
            b_.assert_bool(df[j])
            dacc = df[j] + dacc
        b_.assert_eq(dacc, is_real - ok * is_real)
        sel_c, sel_e = L["sel_c"], L["sel_e"]
        b_.assert_eq(sel_c, sum(df[j] * ct_bytes[j] for j in range(16)))
        b_.assert_eq(sel_e, sum(df[j] * exp_bytes[j] for j in range(16)))
        b_.assert_zero(dacc * ((sel_c - sel_e) * L["dinv"] - 1))

        # result chain + output write
        res_in, res_out = L["res_in"], L["res_out"]
        b_.assert_bool(res_in)
        b_.assert_zero(ev_start * (1 - res_in))
        b_.assert_eq(res_out, res_in * ok)
        b_.when_transition().assert_zero(cont * (N["res_in"] - res_out))
        eval_access(b_, L, "ow", L["shard"], L["clk"], L["output_ptr"],
                    is_last, write=True)
        ov = L.word("ow_value")
        b_.assert_zero(is_last * (ov[0] - res_out))
        for j in (1, 2, 3):
            b_.assert_zero(is_last * ov[j])
