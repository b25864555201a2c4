"""Weierstrass curve precompile chips (secp256k1 / secp256r1 / bn254 add and
double), built on the fixed-modulus byte-limb gadgets in field_gadget.py
(reference: crates/core/machine/src/syscall/precompiles/weierstrass/
weierstrass_add.rs / weierstrass_double.rs — same decomposition into
slope-numerator / slope / x3 / y3 field ops, re-derived for this engine).

Add (distinct affine points, one row per syscall):
    dx = x2 - x1          lin:  dx + x1 - x2 = b*m
    dy = y2 - y1          lin:  dy + y1 - y2 = b*m
    lam * dx = dy  mod m  mul
    lam2 = lam^2   mod m  mul
    x3: x3 + x1 + x2 - lam2 = b*m   (b in 0..2)
    xd = x1 - x3          lin:  xd + x3 - x1 = b*m
    t = lam * xd   mod m  mul
    y3: y3 + y1 - t = b*m
x1,y1 come from the p-write prev-value bytes, x2,y2 from the q-read values,
x3,y3 from the p-write values (byte limbs from the memory-access words);
x3 and y3 are range-checked < m against the constant modulus.

Double: lam * 2y = 3 x^2 + a, same tail. The p point is read unsafely and
overwritten in place (write at clk, no extra cycle — reference
create_ec_double_event), so the only memory accesses are the 16 writes.

The factory is parametrized by words-per-coordinate: 8 for the 256-bit
curves, 12 for bls12-381 (48 byte limbs).
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import SyscallCode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, send_byte
from .field_gadget import ModLinGadget, ModMulGadget, limbs_of
from .layout import Layout, trace_height
from .memory_access import add_access_cols, eval_access

PF = 2130706433  # KoalaBear modulus (canonical trace values)

NL = 32

P256K1 = (1 << 256) - (1 << 32) - 977
P256R1 = (1 << 256) - (1 << 224) + (1 << 192) + (1 << 96) - 1
PBN254 = 21888242871839275222246405745257275088696311157297823662689037894645226208583

PBLS = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab", 16
)

# (name, modulus, curve a, add syscall, double syscall, words per coordinate)
CURVES = [
    ("Secp256k1", P256K1, 0,
     int(SyscallCode.SECP256K1_ADD), int(SyscallCode.SECP256K1_DOUBLE), 8),
    ("Secp256r1", P256R1, P256R1 - 3,
     int(SyscallCode.SECP256R1_ADD), int(SyscallCode.SECP256R1_DOUBLE), 8),
    ("Bn254", PBN254, 0,
     int(SyscallCode.BN254_ADD), int(SyscallCode.BN254_DOUBLE), 8),
    ("Bls12381", PBLS, 0,
     int(SyscallCode.BLS12381_ADD), int(SyscallCode.BLS12381_DOUBLE), 12),
]


def _words_to_int(words8) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words8))


def _word_limbs(view, names) -> list:
    out = []
    for nm in names:
        out += list(view.word(nm))
    return out


def _fill_witness_vec(row, layout, name, value, record=None, nl=NL):
    limbs = limbs_of(value, nl)
    row[layout.slc(name)] = limbs
    if record is not None:
        for k in range(0, nl, 2):
            count(record, B.U8Range, np.array([limbs[k]]), limbs[k + 1])


def _eval_witness_vec(b_, L, name, is_real, nl=NL):
    v = L[name]
    for k in range(0, nl, 2):
        send_byte(b_, B.U8Range, v[k], v[k + 1], 0, is_real)
    return list(v)


def _fill_lt(row, layout, prefix, value, modulus, record=None, nl=NL):
    rl = limbs_of(value, nl)
    ml = limbs_of(modulus, nl)
    df = np.zeros(nl, dtype=np.uint32)
    for k in range(nl - 1, -1, -1):
        if rl[k] != ml[k]:
            df[k] = 1
            row[layout.idx(f"{prefix}_sel")] = rl[k]
            if record is not None:
                count(record, B.LTU, np.array([rl[k]]), ml[k])
            break
    else:
        raise AssertionError("value == modulus")
    row[layout.slc(f"{prefix}_df")] = df


def _eval_lt(b_, L, prefix, r_limbs, modulus, is_real, nl=NL):
    """r < m (constant modulus), lexicographic MSB-first."""
    ml = limbs_of(modulus, nl)
    df = L[f"{prefix}_df"]
    acc = 0
    for k in range(nl):
        b_.assert_bool(df[k])
        acc = df[k] + acc
    b_.assert_eq(acc, is_real)
    for k in range(nl):
        for j in range(k + 1, nl):
            b_.assert_zero(df[k] * (r_limbs[j] - ml[j]))
    # the selected byte is committed so the lookup message stays degree 1
    sel = L[f"{prefix}_sel"]
    b_.assert_eq(sel, sum(df[k] * r_limbs[k] for k in range(nl)))
    sel_m = sum(df[k] * ml[k] for k in range(nl))
    send_byte(b_, B.LTU, sel, sel_m, 1, is_real)


class _WeierstrassBase(Air):
    def _events(self, record):
        from ..executor.precompile_mem import group_events

        group_events(record)  # annotate events with dispatch args
        return record.precompile_events.get(int(self.SYSCALL), [])

    def included(self, record):
        return bool(self._events(record))

    def num_rows(self, record):
        return len(self._events(record))

    def _deps_accesses(self, record, ev, accesses):
        shard = ev["shard"]
        for ts, acc in accesses:
            prev_clk, prev_shard = acc[2], acc[3]
            compare = 1 if prev_shard == shard else 0
            diff = (ts - prev_clk - 1) if compare else (shard - prev_shard - 1)
            count(record, B.U16Range, np.array([diff & 0xFFFF]), 0)
            count(record, B.U8Range, np.array([diff >> 16]), 0)

    @staticmethod
    def _fill_access(r, layout, prefix, acc, ts, shard, write):
        addr, prev_v, prev_clk, prev_shard = acc[0], acc[1], acc[2], acc[3]
        value = acc[4] if write else acc[1]
        compare = 1 if prev_shard == shard else 0
        diff = (ts - prev_clk - 1) if compare else (shard - prev_shard - 1)
        r[layout.idx(f"{prefix}_prev_shard")] = prev_shard
        r[layout.idx(f"{prefix}_prev_clk")] = prev_clk
        r[layout.idx(f"{prefix}_compare_clk")] = compare
        r[layout.idx(f"{prefix}_d16")] = diff & 0xFFFF
        r[layout.idx(f"{prefix}_d8")] = diff >> 16
        for j in range(4):
            r[layout.slc(f"{prefix}_value")][j] = (int(value) >> (8 * j)) & 0xFF
            if write:
                r[layout.slc(f"{prefix}_prev_value")][j] = (
                    int(prev_v) >> (8 * j)
                ) & 0xFF


def _make_add_chip(curve_name, modulus, add_code, nw=8):
    npt, nl = 2 * nw, 4 * nw
    C = Layout().add("shard").add("clk").add("p_ptr").add("q_ptr").add("is_real")
    for i in range(npt):
        add_access_cols(C, f"pw{i}", write=True)
    for i in range(npt):
        add_access_cols(C, f"qr{i}", write=False)
    for nm in ("dx", "dy", "lam", "lam2", "xd", "t"):
        C.add(nm, nl)
    C.add("x3_df", nl).add("y3_df", nl).add("x3_sel").add("y3_sel")
    g_dx = ModLinGadget(C, "gdx", modulus, nl)
    g_dy = ModLinGadget(C, "gdy", modulus, nl)
    g_lam = ModMulGadget(C, "glam", modulus, nl)
    g_lam2 = ModMulGadget(C, "glam2", modulus, nl)
    g_x3 = ModLinGadget(C, "gx3", modulus, nl, max_borrow=2)
    g_xd = ModLinGadget(C, "gxd", modulus, nl)
    g_t = ModMulGadget(C, "gt", modulus, nl)
    g_y3 = ModLinGadget(C, "gy3", modulus, nl)

    def _EVW(b_, L, name, is_real):
        return _eval_witness_vec(b_, L, name, is_real, nl=nl)

    class AddChip(_WeierstrassBase):
        picus_inputs = ("shard", "clk", "p_ptr", "q_ptr", "is_real")
        picus_outputs = ("dx", "dy", "lam", "lam2", "xd", "t",
                         "x3_df", "y3_df", "x3_sel", "y3_sel")
        name = f"{curve_name}Add"
        SYSCALL = add_code
        COLS = C
        width = C.width

        def generate_dependencies(self, record, output):
            for ev in self._events(record):
                clk = ev["clk"]
                self._deps_accesses(
                    record, ev,
                    [(clk, a) for a in ev["reads"]]
                    + [(clk + 1, a) for a in ev["writes"]],
                )
                row = np.zeros(C.width, dtype=np.uint32)
                self._fill_math(row, ev, record)

        def _fill_math(self, row, ev, record=None):
            m = modulus
            x1 = _words_to_int([w[1] for w in ev["writes"][:nw]])
            y1 = _words_to_int([w[1] for w in ev["writes"][nw:]])
            x2 = _words_to_int([r[1] for r in ev["reads"][:nw]])
            y2 = _words_to_int([r[1] for r in ev["reads"][nw:]])
            x3 = _words_to_int([w[4] for w in ev["writes"][:nw]])
            y3 = _words_to_int([w[4] for w in ev["writes"][nw:]])
            dx, dy = (x2 - x1) % m, (y2 - y1) % m
            lam = (dy * pow(dx, m - 2, m)) % m
            lam2 = (lam * lam) % m
            xd = (x1 - x3) % m
            t = (lam * xd) % m
            for nm, v in (("dx", dx), ("dy", dy), ("lam", lam),
                          ("lam2", lam2), ("xd", xd), ("t", t)):
                _fill_witness_vec(row, C, nm, v, record, nl=nl)
            g_dx.fill(row, C, [(1, dx), (1, x1), (-1, x2)], record)
            g_dy.fill(row, C, [(1, dy), (1, y1), (-1, y2)], record)
            g_lam.fill(row, C, lam, dx, dy, record)
            g_lam2.fill(row, C, lam, lam, lam2, record)
            g_x3.fill(row, C, [(1, x3), (1, x1), (1, x2), (-1, lam2)], record)
            g_xd.fill(row, C, [(1, xd), (1, x3), (-1, x1)], record)
            g_t.fill(row, C, lam, xd, t, record)
            g_y3.fill(row, C, [(1, y3), (1, y1), (-1, t)], record)
            _fill_lt(row, C, "x3", x3, m, record, nl=nl)
            _fill_lt(row, C, "y3", y3, m, record, nl=nl)
            return row

        def generate_trace(self, record, output):
            events = self._events(record)
            n = len(events)
            height = trace_height(n)
            mat = np.zeros((height, C.width), dtype=np.uint32)
            for r_i, ev in enumerate(events):
                row = self._fill_math(mat[r_i], ev)
                row[C.idx("shard")] = ev["shard"]
                row[C.idx("clk")] = ev["clk"]
                row[C.idx("p_ptr")] = ev["p_ptr"]
                row[C.idx("q_ptr")] = ev["q_ptr"]
                row[C.idx("is_real")] = 1
                for i in range(npt):
                    self._fill_access(row, C, f"pw{i}", ev["writes"][i],
                                      ev["clk"] + 1, ev["shard"], True)
                    self._fill_access(row, C, f"qr{i}", ev["reads"][i],
                                      ev["clk"], ev["shard"], False)
            for g in (g_lam, g_lam2, g_t):
                g.fill_padding(mat, C, n)
            for g in (g_dx, g_dy, g_x3, g_xd, g_y3):
                g.fill_padding(mat, C, n)
            return mat

        def eval(self, b_):
            L = C.view(b_.main_local)
            is_real = L["is_real"]
            b_.assert_bool(is_real)
            b_.receive(
                LookupKind.Syscall,
                [L["shard"], L["clk"], self.SYSCALL, L["p_ptr"], L["q_ptr"]],
                is_real,
            )
            for i in range(npt):
                eval_access(b_, L, f"qr{i}", L["shard"], L["clk"],
                            L["q_ptr"] + 4 * i, is_real, write=False)
                eval_access(b_, L, f"pw{i}", L["shard"], L["clk"] + 1,
                            L["p_ptr"] + 4 * i, is_real, write=True)
            x1 = _word_limbs(L, [f"pw{i}_prev_value" for i in range(nw)])
            y1 = _word_limbs(L, [f"pw{i}_prev_value" for i in range(nw, npt)])
            x2 = _word_limbs(L, [f"qr{i}_value" for i in range(nw)])
            y2 = _word_limbs(L, [f"qr{i}_value" for i in range(nw, npt)])
            x3 = _word_limbs(L, [f"pw{i}_value" for i in range(nw)])
            y3 = _word_limbs(L, [f"pw{i}_value" for i in range(nw, npt)])
            dx = _EVW(b_, L, "dx", is_real)
            dy = _EVW(b_, L, "dy", is_real)
            lam = _EVW(b_, L, "lam", is_real)
            lam2 = _EVW(b_, L, "lam2", is_real)
            xd = _EVW(b_, L, "xd", is_real)
            t = _EVW(b_, L, "t", is_real)
            g_dx.eval(b_, L, [(1, dx), (1, x1), (-1, x2)], is_real)
            g_dy.eval(b_, L, [(1, dy), (1, y1), (-1, y2)], is_real)
            g_lam.eval(b_, L, lam, dx, dy, is_real)
            g_lam2.eval(b_, L, lam, lam, lam2, is_real)
            g_x3.eval(b_, L, [(1, x3), (1, x1), (1, x2), (-1, lam2)], is_real)
            g_xd.eval(b_, L, [(1, xd), (1, x3), (-1, x1)], is_real)
            g_t.eval(b_, L, lam, xd, t, is_real)
            g_y3.eval(b_, L, [(1, y3), (1, y1), (-1, t)], is_real)
            _eval_lt(b_, L, "x3", x3, modulus, is_real, nl=nl)
            _eval_lt(b_, L, "y3", y3, modulus, is_real, nl=nl)

    return AddChip


def _make_double_chip(curve_name, modulus, a_coef, double_code, nw=8):
    npt, nl = 2 * nw, 4 * nw
    C = Layout().add("shard").add("clk").add("p_ptr").add("arg2").add("is_real")
    for i in range(npt):
        add_access_cols(C, f"pw{i}", write=True)
    for nm in ("ty", "x2c", "tx", "lam", "lam2", "xd", "t"):
        C.add(nm, nl)
    C.add("x3_df", nl).add("y3_df", nl).add("x3_sel").add("y3_sel")
    g_ty = ModLinGadget(C, "gty", modulus, nl)
    g_x2c = ModMulGadget(C, "gx2c", modulus, nl)
    g_tx = ModLinGadget(C, "gtx", modulus, nl, max_borrow=3)
    g_lam = ModMulGadget(C, "glam", modulus, nl)
    g_lam2 = ModMulGadget(C, "glam2", modulus, nl)
    g_x3 = ModLinGadget(C, "gx3", modulus, nl, max_borrow=2)
    g_xd = ModLinGadget(C, "gxd", modulus, nl)
    g_t = ModMulGadget(C, "gt", modulus, nl)
    g_y3 = ModLinGadget(C, "gy3", modulus, nl)

    def _EVW(b_, L, name, is_real):
        return _eval_witness_vec(b_, L, name, is_real, nl=nl)

    class DoubleChip(_WeierstrassBase):
        picus_inputs = ("shard", "clk", "p_ptr", "arg2", "is_real")
        picus_outputs = ("ty", "x2c", "tx", "lam", "lam2", "xd", "t",
                         "x3_df", "y3_df", "x3_sel", "y3_sel")
        name = f"{curve_name}Double"
        SYSCALL = double_code
        COLS = C
        width = C.width

        def generate_dependencies(self, record, output):
            for ev in self._events(record):
                clk = ev["clk"]
                self._deps_accesses(record, ev, [(clk, a) for a in ev["writes"]])
                row = np.zeros(C.width, dtype=np.uint32)
                self._fill_math(row, ev, record)

        def _fill_math(self, row, ev, record=None):
            m = modulus
            x1 = _words_to_int([w[1] for w in ev["writes"][:nw]])
            y1 = _words_to_int([w[1] for w in ev["writes"][nw:]])
            x3 = _words_to_int([w[4] for w in ev["writes"][:nw]])
            y3 = _words_to_int([w[4] for w in ev["writes"][nw:]])
            ty = (2 * y1) % m
            x2c = (x1 * x1) % m
            tx = (3 * x2c + a_coef) % m
            lam = (tx * pow(ty, m - 2, m)) % m
            lam2 = (lam * lam) % m
            xd = (x1 - x3) % m
            t = (lam * xd) % m
            for nm, v in (("ty", ty), ("x2c", x2c), ("tx", tx), ("lam", lam),
                          ("lam2", lam2), ("xd", xd), ("t", t)):
                _fill_witness_vec(row, C, nm, v, record, nl=nl)
            g_ty.fill(row, C, [(2, y1), (-1, ty)], record)
            g_x2c.fill(row, C, x1, x1, x2c, record)
            g_tx.fill(row, C, [(3, x2c), (1, a_coef), (-1, tx)], record)
            g_lam.fill(row, C, lam, ty, tx, record)
            g_lam2.fill(row, C, lam, lam, lam2, record)
            g_x3.fill(row, C, [(1, x3), (2, x1), (-1, lam2)], record)
            g_xd.fill(row, C, [(1, xd), (1, x3), (-1, x1)], record)
            g_t.fill(row, C, lam, xd, t, record)
            g_y3.fill(row, C, [(1, y3), (1, y1), (-1, t)], record)
            _fill_lt(row, C, "x3", x3, m, record, nl=nl)
            _fill_lt(row, C, "y3", y3, m, record, nl=nl)
            return row

        def generate_trace(self, record, output):
            events = self._events(record)
            n = len(events)
            height = trace_height(n)
            mat = np.zeros((height, C.width), dtype=np.uint32)
            for r_i, ev in enumerate(events):
                row = self._fill_math(mat[r_i], ev)
                row[C.idx("shard")] = ev["shard"]
                row[C.idx("clk")] = ev["clk"]
                row[C.idx("p_ptr")] = ev["p_ptr"]
                row[C.idx("arg2")] = ev["_arg2"] % PF
                row[C.idx("is_real")] = 1
                for i in range(npt):
                    self._fill_access(row, C, f"pw{i}", ev["writes"][i],
                                      ev["clk"], ev["shard"], True)
            for g in (g_x2c, g_lam, g_lam2, g_t):
                g.fill_padding(mat, C, n)
            for g in (g_ty, g_tx, g_x3, g_xd, g_y3):
                g.fill_padding(mat, C, n)
            return mat

        def eval(self, b_):
            L = C.view(b_.main_local)
            is_real = L["is_real"]
            b_.assert_bool(is_real)
            b_.receive(
                LookupKind.Syscall,
                [L["shard"], L["clk"], self.SYSCALL, L["p_ptr"], L["arg2"]],
                is_real,
            )
            for i in range(npt):
                eval_access(b_, L, f"pw{i}", L["shard"], L["clk"],
                            L["p_ptr"] + 4 * i, is_real, write=True)
            x1 = _word_limbs(L, [f"pw{i}_prev_value" for i in range(nw)])
            y1 = _word_limbs(L, [f"pw{i}_prev_value" for i in range(nw, npt)])
            x3 = _word_limbs(L, [f"pw{i}_value" for i in range(nw)])
            y3 = _word_limbs(L, [f"pw{i}_value" for i in range(nw, npt)])
            ty = _EVW(b_, L, "ty", is_real)
            x2c = _EVW(b_, L, "x2c", is_real)
            tx = _EVW(b_, L, "tx", is_real)
            lam = _EVW(b_, L, "lam", is_real)
            lam2 = _EVW(b_, L, "lam2", is_real)
            xd = _EVW(b_, L, "xd", is_real)
            t = _EVW(b_, L, "t", is_real)
            a_limbs = limbs_of(a_coef, nl)
            g_ty.eval(b_, L, [(2, y1), (-1, ty)], is_real)
            g_x2c.eval(b_, L, x1, x1, x2c, is_real)
            g_tx.eval(b_, L, [(3, x2c), (1, a_limbs), (-1, tx)], is_real,
                      gate=is_real if a_coef else None)
            g_lam.eval(b_, L, lam, ty, tx, is_real)
            g_lam2.eval(b_, L, lam, lam, lam2, is_real)
            g_x3.eval(b_, L, [(1, x3), (2, x1), (-1, lam2)], is_real)
            g_xd.eval(b_, L, [(1, xd), (1, x3), (-1, x1)], is_real)
            g_t.eval(b_, L, lam, xd, t, is_real)
            g_y3.eval(b_, L, [(1, y3), (1, y1), (-1, t)], is_real)
            _eval_lt(b_, L, "x3", x3, modulus, is_real, nl=nl)
            _eval_lt(b_, L, "y3", y3, modulus, is_real, nl=nl)

    return DoubleChip


def _make_decompress_chip(curve_name, modulus, a_coef, b_coef, code, nw,
                          lexicographic):
    """Weierstrass decompress chip: recover y from (x, sign) with
    y^2 = x^3 + ax + b, y < p, and the curve's sign convention — parity of
    y (SEC1; secp256k1/secp256r1) or lexicographically-largest y (ZCash;
    bls12-381). Reference: crates/core/machine/src/syscall/precompiles/
    weierstrass/weierstrass_decompress.rs (SignChoiceRule), re-derived on
    this engine's byte-limb gadgets. Event: x read at ptr + 4*nw at clk,
    y written at ptr at clk, 0 extra cycles."""
    nl = nw * 4
    npt = 2 * nw
    m = modulus
    half_p = (m + 1) // 2

    C = Layout().add("shard").add("clk").add("ptr").add("sign").add("is_real")
    for i in range(nw):
        add_access_cols(C, f"yw{i}", write=True)
    for i in range(nw):
        add_access_cols(C, f"xr{i}", write=False)
    for nm in ("xx", "x3c", "rhs"):
        C.add(nm, nl)
    g_xx = ModMulGadget(C, "gxx", m, nl)
    g_x3 = ModMulGadget(C, "gx3", m, nl)
    g_ax = ModMulGadget(C, "gax", m, nl) if a_coef else None
    if a_coef:
        C.add("axv", nl)
    g_rhs = ModLinGadget(C, "grhs", m, nl, max_borrow=2)
    g_yy = ModMulGadget(C, "gyy", m, nl)
    C.add("x_df", nl).add("x_sel")
    C.add("y_df", nl).add("y_sel")
    if lexicographic:
        C.add("neg_y", nl)
        g_neg = ModLinGadget(C, "gneg", m, nl, max_borrow=1)
        C.add("sel_df", nl).add("sel_sel").add("ynz_inv")
    else:
        C.add("h0")
    a_limbs = limbs_of(a_coef, nl) if a_coef else None
    b_limbs = limbs_of(b_coef, nl)

    class DecompressChip(_WeierstrassBase):
        picus_inputs = ("shard", "clk", "ptr", "sign", "is_real")
        picus_outputs = ("x_df", "x_sel", "y_df", "y_sel")
        name = f"{curve_name}Decompress"
        SYSCALL = code
        COLS = C
        width = C.width

        def generate_dependencies(self, record, output):
            for ev in self._events(record):
                clk = ev["clk"]
                self._deps_accesses(
                    record, ev,
                    [(clk, a) for a in ev["reads"]]
                    + [(clk, a) for a in ev["writes"]],
                )
                row = np.zeros(C.width, dtype=np.uint32)
                self._fill_math(row, ev, record)

        def _fill_math(self, row, ev, record=None):
            x = _words_to_int([r[1] for r in ev["reads"]])
            y = _words_to_int([w[4] for w in ev["writes"]])
            sign = ev["sign"]
            xx = (x * x) % m
            x3c = (xx * x) % m
            rhs = (x3c + a_coef * x + b_coef) % m
            vals = [("xx", xx), ("x3c", x3c), ("rhs", rhs)]
            if a_coef:
                axv = (a_coef * x) % m
                vals.append(("axv", axv))
            for col, v in vals:
                _fill_witness_vec(row, C, col, v, record, nl=nl)
            g_xx.fill(row, C, x, x, xx, record)
            g_x3.fill(row, C, xx, x, x3c, record)
            if a_coef:
                g_ax.fill(row, C, a_coef, x, axv, record)
                g_rhs.fill(row, C, [(1, x3c), (1, axv), (1, b_coef),
                                    (-1, rhs)], record)
            else:
                g_rhs.fill(row, C, [(1, x3c), (1, b_coef), (-1, rhs)], record)
            g_yy.fill(row, C, y, y, rhs, record)
            _fill_lt(row, C, "x", x, m, record, nl=nl)
            _fill_lt(row, C, "y", y, m, record, nl=nl)
            if lexicographic:
                neg_y = (m - y) % m
                row[C.slc("neg_y")] = limbs_of(neg_y, nl)
                if record is not None:
                    ls = limbs_of(neg_y, nl)
                    for k in range(0, nl, 2):
                        count(record, B.U8Range, np.array([ls[k]]), ls[k + 1])
                g_neg.fill(row, C, [(1, y), (1, neg_y)], record)
                _fill_lt(row, C, "sel", neg_y if sign else y, half_p,
                         record, nl=nl)
                if sign:
                    from ..core.field import P_INT

                    ysum = sum(limbs_of(y, nl))
                    row[C.idx("ynz_inv")] = pow(ysum, P_INT - 2, P_INT)
            else:
                row[C.idx("h0")] = (y & 0xFF) >> 1
                if record is not None:
                    count(record, B.LTU, np.array([(y & 0xFF) >> 1]), 128)
            return row

        def generate_trace(self, record, output):
            events = self._events(record)
            n = len(events)
            height = trace_height(n)
            mat = np.zeros((height, C.width), dtype=np.uint32)
            for r_i, ev in enumerate(events):
                row = self._fill_math(mat[r_i], ev)
                row[C.idx("shard")] = ev["shard"]
                row[C.idx("clk")] = ev["clk"]
                row[C.idx("ptr")] = ev["ptr"]
                row[C.idx("sign")] = ev["sign"]
                row[C.idx("is_real")] = 1
                for i in range(nw):
                    self._fill_access(row, C, f"xr{i}", ev["reads"][i],
                                      ev["clk"], ev["shard"], False)
                    self._fill_access(row, C, f"yw{i}", ev["writes"][i],
                                      ev["clk"], ev["shard"], True)
            gads = [g_xx, g_x3, g_yy] + ([g_ax] if a_coef else [])
            for g in gads:
                g.fill_padding(mat, C, n)
            g_rhs.fill_padding(mat, C, n)
            if lexicographic:
                g_neg.fill_padding(mat, C, n)
            return mat

        def eval(self, b_):
            L = C.view(b_.main_local)
            is_real = L["is_real"]
            sign = L["sign"]
            b_.assert_bool(is_real)
            b_.assert_bool(sign)
            b_.receive(
                LookupKind.Syscall,
                [L["shard"], L["clk"], self.SYSCALL, L["ptr"], sign],
                is_real,
            )
            for i in range(nw):
                eval_access(b_, L, f"xr{i}", L["shard"], L["clk"],
                            L["ptr"] + 4 * nw + 4 * i, is_real, write=False)
                eval_access(b_, L, f"yw{i}", L["shard"], L["clk"],
                            L["ptr"] + 4 * i, is_real, write=True)
            x = _word_limbs(L, [f"xr{i}_value" for i in range(nw)])
            y = _word_limbs(L, [f"yw{i}_value" for i in range(nw)])
            xx = _eval_witness_vec(b_, L, "xx", is_real, nl=nl)
            x3c = _eval_witness_vec(b_, L, "x3c", is_real, nl=nl)
            rhs = _eval_witness_vec(b_, L, "rhs", is_real, nl=nl)
            g_xx.eval(b_, L, x, x, xx, is_real)
            g_x3.eval(b_, L, xx, x, x3c, is_real)
            if a_coef:
                axv = _eval_witness_vec(b_, L, "axv", is_real, nl=nl)
                g_ax.eval(b_, L, a_limbs, x, axv, is_real)
                g_rhs.eval(b_, L, [(1, x3c), (1, axv), (1, b_limbs),
                                   (-1, rhs)], is_real, gate=is_real)
            else:
                g_rhs.eval(b_, L, [(1, x3c), (1, b_limbs), (-1, rhs)],
                           is_real, gate=is_real)
            g_yy.eval(b_, L, y, y, rhs, is_real)
            _eval_lt(b_, L, "x", x, m, is_real, nl=nl)
            _eval_lt(b_, L, "y", y, m, is_real, nl=nl)
            if lexicographic:
                # sign = [y is the lexicographically larger root]:
                #   neg_y = -y mod p (byte witness), and the root selected
                #   by the sign is < (p+1)/2; when sign=1 additionally
                #   y != 0 so y + neg_y = p exactly as integers
                neg_y = _eval_witness_vec(b_, L, "neg_y", is_real, nl=nl)
                g_neg.eval(b_, L, [(1, y), (1, neg_y)], is_real)
                sel = [y[k] + sign * (neg_y[k] - y[k]) for k in range(nl)]
                _eval_lt(b_, L, "sel", sel, half_p, is_real, nl=nl)
                ysum = sum(y)
                b_.assert_zero(sign * (L["ynz_inv"] * ysum - 1))
            else:
                # SEC1: sign is the parity of y — y0 = 2 h0 + sign, h0 < 128
                h0 = L["h0"]
                b_.when(is_real).assert_eq(y[0], 2 * h0 + sign)
                send_byte(b_, B.LTU, h0, 128, 1, is_real)

    return DecompressChip


# (name, modulus, a, b, decompress syscall, words/coordinate, lexicographic)
DECOMPRESS_CURVES = [
    ("Secp256k1", P256K1, 0, 7,
     int(SyscallCode.SECP256K1_DECOMPRESS), 8, False),
    ("Secp256r1", P256R1, P256R1 - 3,
     int("5ac635d8aa3a93e7b3ebbd55769886bc651d06b0cc53b0f63bce3c3e27d2604b",
         16),
     int(SyscallCode.SECP256R1_DECOMPRESS), 8, False),
    ("Bls12381", PBLS, 0, 4,
     int(SyscallCode.BLS12381_DECOMPRESS), 12, True),
]

_CHIP_CLASSES = None


def curve_chips() -> list:
    """All weierstrass precompile chips (add + double per curve, decompress
    where the reference has one). The factory classes are built once so the
    per-class symbolic-pass cache in stark/chip.py stays warm across
    machines."""
    global _CHIP_CLASSES
    if _CHIP_CLASSES is None:
        _CHIP_CLASSES = []
        for name, modulus, a_coef, add_code, double_code, nw in CURVES:
            _CHIP_CLASSES.append(_make_add_chip(name, modulus, add_code, nw=nw))
            _CHIP_CLASSES.append(
                _make_double_chip(name, modulus, a_coef, double_code, nw=nw)
            )
        for name, modulus, a_coef, b_coef, code, nw, lex in DECOMPRESS_CURVES:
            _CHIP_CLASSES.append(
                _make_decompress_chip(name, modulus, a_coef, b_coef, code,
                                      nw, lex)
            )
    return [cls() for cls in _CHIP_CLASSES]


# Backwards-compatible names for the secp256k1 chips
Secp256k1AddChip = _make_add_chip("Secp256k1", P256K1, int(SyscallCode.SECP256K1_ADD))
Secp256k1DoubleChip = _make_double_chip(
    "Secp256k1", P256K1, 0, int(SyscallCode.SECP256K1_DOUBLE)
)