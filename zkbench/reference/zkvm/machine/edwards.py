"""Ed25519 (twisted Edwards, a = -1) complete-addition precompile chip
(reference: crates/core/machine/src/syscall/precompiles/edwards/ed_add.rs —
same A/B/C/D/E decomposition, re-derived on this engine's field gadgets):

    A = x1*x2   B = y1*y2   C = x1*y2   D = x2*y1
    E = d*A*B   (via da = d*A, E = da*B; d is the curve constant)
    x3 * (1 + E) = C + D        y3 * (1 - E) = A + B

The addition law is complete on the twisted curve, so a single chip covers
add and double. Event shape matches the weierstrass add (q read at clk,
p overwritten at clk + 1)."""

from __future__ import annotations

import numpy as np

from ..executor.opcode import SyscallCode
from ..stark.lookup import LookupKind
from .field_gadget import ModLinGadget, ModMulGadget, limbs_of
from .layout import Layout, trace_height
from .memory_access import add_access_cols, eval_access
from .weierstrass import (
    NL,
    _WeierstrassBase,
    _eval_lt,
    _eval_witness_vec,
    _fill_lt,
    _fill_witness_vec,
    _word_limbs,
    _words_to_int,
)

P25519 = (1 << 255) - 19
ED_D = 37095705934669439343138083508754565189542113879843219016388785533085940283555

COLS = Layout().add("shard").add("clk").add("p_ptr").add("q_ptr").add("is_real")
for i in range(16):
    add_access_cols(COLS, f"pw{i}", write=True)
for i in range(16):
    add_access_cols(COLS, f"qr{i}", write=False)
for nm in ("A", "B", "Cv", "Dv", "da", "E", "nx", "dxv", "ny", "dyv"):
    COLS.add(nm, NL)
COLS.add("x3_df", NL).add("y3_df", NL).add("x3_sel").add("y3_sel")
G_A = ModMulGadget(COLS, "ga", P25519, NL)
G_B = ModMulGadget(COLS, "gb", P25519, NL)
G_C = ModMulGadget(COLS, "gc", P25519, NL)
G_D = ModMulGadget(COLS, "gd", P25519, NL)
G_DA = ModMulGadget(COLS, "gda", P25519, NL)
G_E = ModMulGadget(COLS, "ge", P25519, NL)
G_NX = ModLinGadget(COLS, "gnx", P25519, NL)
G_DX = ModLinGadget(COLS, "gdxv", P25519, NL)
G_NY = ModLinGadget(COLS, "gny", P25519, NL)
G_DY = ModLinGadget(COLS, "gdyv", P25519, NL)
G_MX = ModMulGadget(COLS, "gmx", P25519, NL)
G_MY = ModMulGadget(COLS, "gmy", P25519, NL)

_ONE = [1] + [0] * (NL - 1)
_D_LIMBS = limbs_of(ED_D, NL)


DCOLS = Layout().add("shard").add("clk").add("ptr").add("sign").add("is_real")
for i in range(8):
    add_access_cols(DCOLS, f"xw{i}", write=True)
for i in range(8):
    add_access_cols(DCOLS, f"yr{i}", write=False)
for nm in ("ys", "td", "dn", "nm", "xx"):
    DCOLS.add(nm, NL)
DCOLS.add("bit255").add("h0")
DCOLS.add("x_df", NL).add("x_sel")
DG_YS = ModMulGadget(DCOLS, "dgys", P25519, NL)
DG_TD = ModMulGadget(DCOLS, "dgtd", P25519, NL)
DG_DN = ModLinGadget(DCOLS, "dgdn", P25519, NL)
DG_NM = ModLinGadget(DCOLS, "dgnm", P25519, NL)
DG_XX = ModMulGadget(DCOLS, "dgxx", P25519, NL)
DG_E = ModMulGadget(DCOLS, "dge", P25519, NL)


class EdDecompressChip(_WeierstrassBase):
    picus_inputs = ("shard", "clk", "ptr", "sign", "is_real")
    picus_outputs = ("bit255", "h0", "x_df", "x_sel")
    """Recover x from (y, sign): x^2 (d y^2 + 1) = y^2 - 1, lsb(x) = sign,
    x canonical (reference: edwards/ed_decompress.rs). Bit 255 of the stored
    y bytes is ignored (committed via an MSB byte lookup on the top byte)."""

    name = "EdDecompress"
    SYSCALL = int(SyscallCode.ED_DECOMPRESS)
    COLS = DCOLS
    width = DCOLS.width

    def generate_dependencies(self, record, output):
        for ev in self._events(record):
            clk = ev["clk"]
            self._deps_accesses(
                record, ev,
                [(clk, a) for a in ev["reads"]]
                + [(clk, a) for a in ev["writes"]],
            )
            row = np.zeros(DCOLS.width, dtype=np.uint32)
            self._fill_math(row, ev, record)

    def _fill_math(self, row, ev, record=None):
        from ..executor.opcode import ByteOpcode as B
        from .byte import count

        m = P25519
        y_raw = _words_to_int([r[1] for r in ev["reads"]])
        x = _words_to_int([w[4] for w in ev["writes"]])
        bit255 = (y_raw >> 255) & 1
        y = y_raw & ((1 << 255) - 1)
        ys = (y * y) % m
        td = (ED_D * ys) % m
        dn = (td + 1) % m
        nm = (ys - 1) % m
        xx = (x * x) % m
        for col, v in (("ys", ys), ("td", td), ("dn", dn), ("nm", nm),
                       ("xx", xx)):
            _fill_witness_vec(row, DCOLS, col, v, record)
        row[DCOLS.idx("bit255")] = bit255
        row[DCOLS.idx("h0")] = (x & 0xFF) >> 1
        if record is not None:
            top = (y_raw >> 248) & 0xFF
            count(record, B.MSB, np.array([top]), 0)
            count(record, B.LTU, np.array([(x & 0xFF) >> 1]), 128)
        DG_YS.fill(row, DCOLS, y, y, ys, record)
        DG_TD.fill(row, DCOLS, ED_D, ys, td, record)
        DG_DN.fill(row, DCOLS, [(1, td), (1, 1), (-1, dn)], record)
        DG_NM.fill(row, DCOLS, [(1, nm), (1, 1), (-1, ys)], record)
        DG_XX.fill(row, DCOLS, x, x, xx, record)
        DG_E.fill(row, DCOLS, xx, dn, nm, record)
        _fill_lt(row, DCOLS, "x", x, m, record)
        return row

    def generate_trace(self, record, output):
        events = self._events(record)
        n = len(events)
        height = trace_height(n)
        mat = np.zeros((height, DCOLS.width), dtype=np.uint32)
        for r_i, ev in enumerate(events):
            row = self._fill_math(mat[r_i], ev)
            row[DCOLS.idx("shard")] = ev["shard"]
            row[DCOLS.idx("clk")] = ev["clk"]
            row[DCOLS.idx("ptr")] = ev["ptr"]
            row[DCOLS.idx("sign")] = ev["sign"]
            row[DCOLS.idx("is_real")] = 1
            for i in range(8):
                self._fill_access(row, DCOLS, f"xw{i}", ev["writes"][i],
                                  ev["clk"], ev["shard"], True)
                self._fill_access(row, DCOLS, f"yr{i}", ev["reads"][i],
                                  ev["clk"], ev["shard"], False)
        for g in (DG_YS, DG_TD, DG_XX, DG_E):
            g.fill_padding(mat, DCOLS, n)
        for g in (DG_DN, DG_NM):
            g.fill_padding(mat, DCOLS, n)
        return mat

    def eval(self, b_):
        from ..executor.opcode import ByteOpcode as B
        from .byte import send_byte

        L = DCOLS.view(b_.main_local)
        is_real = L["is_real"]
        sign = L["sign"]
        b_.assert_bool(is_real)
        b_.assert_bool(sign)
        b_.receive(
            LookupKind.Syscall,
            [L["shard"], L["clk"], self.SYSCALL, L["ptr"], sign],
            is_real,
        )
        for i in range(8):
            eval_access(b_, L, f"yr{i}", L["shard"], L["clk"],
                        L["ptr"] + 32 + 4 * i, is_real, write=False)
            eval_access(b_, L, f"xw{i}", L["shard"], L["clk"],
                        L["ptr"] + 4 * i, is_real, write=True)
        y_limbs = _word_limbs(L, [f"yr{i}_value" for i in range(8)])
        x_limbs = _word_limbs(L, [f"xw{i}_value" for i in range(8)])
        # strip the ignored bit 255 from the top byte
        bit255 = L["bit255"]
        b_.assert_bool(bit255)
        send_byte(b_, B.MSB, y_limbs[31], 0, bit255, is_real)
        y_eff = list(y_limbs)
        y_eff[31] = y_limbs[31] - 128 * bit255
        ys = _eval_witness_vec(b_, L, "ys", is_real)
        td = _eval_witness_vec(b_, L, "td", is_real)
        dn = _eval_witness_vec(b_, L, "dn", is_real)
        nm = _eval_witness_vec(b_, L, "nm", is_real)
        xx = _eval_witness_vec(b_, L, "xx", is_real)
        one = [1] + [0] * (NL - 1)
        DG_YS.eval(b_, L, y_eff, y_eff, ys, is_real)
        DG_TD.eval(b_, L, _D_LIMBS, ys, td, is_real)
        DG_DN.eval(b_, L, [(1, td), (1, one), (-1, dn)], is_real, gate=is_real)
        DG_NM.eval(b_, L, [(1, nm), (1, one), (-1, ys)], is_real, gate=is_real)
        DG_XX.eval(b_, L, x_limbs, x_limbs, xx, is_real)
        DG_E.eval(b_, L, xx, dn, nm, is_real)
        # parity: x byte 0 = 2 h0 + sign, h0 < 128
        h0 = L["h0"]
        b_.when(is_real).assert_eq(x_limbs[0], 2 * h0 + sign)
        send_byte(b_, B.LTU, h0, 128, 1, is_real)
        _eval_lt(b_, L, "x", x_limbs, P25519, is_real)


class EdAddChip(_WeierstrassBase):
    picus_inputs = ("shard", "clk", "p_ptr", "q_ptr", "is_real")
    picus_outputs = ()
    name = "EdAdd"
    SYSCALL = int(SyscallCode.ED_ADD)
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
            row = np.zeros(COLS.width, dtype=np.uint32)
            self._fill_math(row, ev, record)

    def _fill_math(self, row, ev, record=None):
        m = P25519
        x1 = _words_to_int([w[1] for w in ev["writes"][:8]])
        y1 = _words_to_int([w[1] for w in ev["writes"][8:]])
        x2 = _words_to_int([r[1] for r in ev["reads"][:8]])
        y2 = _words_to_int([r[1] for r in ev["reads"][8:]])
        x3 = _words_to_int([w[4] for w in ev["writes"][:8]])
        y3 = _words_to_int([w[4] for w in ev["writes"][8:]])
        A, B = (x1 * x2) % m, (y1 * y2) % m
        Cv, Dv = (x1 * y2) % m, (x2 * y1) % m
        da = (ED_D * A) % m
        E = (da * B) % m
        nx, dxv = (Cv + Dv) % m, (1 + E) % m
        ny, dyv = (A + B) % m, (1 - E) % m
        for nm, v in (("A", A), ("B", B), ("Cv", Cv), ("Dv", Dv), ("da", da),
                      ("E", E), ("nx", nx), ("dxv", dxv), ("ny", ny),
                      ("dyv", dyv)):
            _fill_witness_vec(row, COLS, nm, v, record)
        G_A.fill(row, COLS, x1, x2, A, record)
        G_B.fill(row, COLS, y1, y2, B, record)
        G_C.fill(row, COLS, x1, y2, Cv, record)
        G_D.fill(row, COLS, x2, y1, Dv, record)
        G_DA.fill(row, COLS, ED_D, A, da, record)
        G_E.fill(row, COLS, da, B, E, record)
        G_NX.fill(row, COLS, [(1, Cv), (1, Dv), (-1, nx)], record)
        G_DX.fill(row, COLS, [(1, 1), (1, E), (-1, dxv)], record)
        G_NY.fill(row, COLS, [(1, A), (1, B), (-1, ny)], record)
        G_DY.fill(row, COLS, [(1, dyv), (1, E), (-1, 1)], record)
        G_MX.fill(row, COLS, x3, dxv, nx, record)
        G_MY.fill(row, COLS, y3, dyv, ny, record)
        _fill_lt(row, COLS, "x3", x3, m, record)
        _fill_lt(row, COLS, "y3", y3, m, record)
        return row

    def generate_trace(self, record, output):
        events = self._events(record)
        n = len(events)
        height = trace_height(n)
        mat = np.zeros((height, COLS.width), dtype=np.uint32)
        for r_i, ev in enumerate(events):
            row = self._fill_math(mat[r_i], ev)
            row[COLS.idx("shard")] = ev["shard"]
            row[COLS.idx("clk")] = ev["clk"]
            row[COLS.idx("p_ptr")] = ev["p_ptr"]
            row[COLS.idx("q_ptr")] = ev["q_ptr"]
            row[COLS.idx("is_real")] = 1
            for i in range(16):
                self._fill_access(row, COLS, f"pw{i}", ev["writes"][i],
                                  ev["clk"] + 1, ev["shard"], True)
                self._fill_access(row, COLS, f"qr{i}", ev["reads"][i],
                                  ev["clk"], ev["shard"], False)
        for g in (G_A, G_B, G_C, G_D, G_DA, G_E, G_MX, G_MY):
            g.fill_padding(mat, COLS, n)
        for g in (G_NX, G_DX, G_NY, G_DY):
            g.fill_padding(mat, COLS, n)
        return mat

    def eval(self, b_):
        L = COLS.view(b_.main_local)
        is_real = L["is_real"]
        b_.assert_bool(is_real)
        b_.receive(
            LookupKind.Syscall,
            [L["shard"], L["clk"], self.SYSCALL, L["p_ptr"], L["q_ptr"]],
            is_real,
        )
        for i in range(16):
            eval_access(b_, L, f"qr{i}", L["shard"], L["clk"],
                        L["q_ptr"] + 4 * i, is_real, write=False)
            eval_access(b_, L, f"pw{i}", L["shard"], L["clk"] + 1,
                        L["p_ptr"] + 4 * i, is_real, write=True)
        x1 = _word_limbs(L, [f"pw{i}_prev_value" for i in range(8)])
        y1 = _word_limbs(L, [f"pw{i}_prev_value" for i in range(8, 16)])
        x2 = _word_limbs(L, [f"qr{i}_value" for i in range(8)])
        y2 = _word_limbs(L, [f"qr{i}_value" for i in range(8, 16)])
        x3 = _word_limbs(L, [f"pw{i}_value" for i in range(8)])
        y3 = _word_limbs(L, [f"pw{i}_value" for i in range(8, 16)])
        A = _eval_witness_vec(b_, L, "A", is_real)
        B = _eval_witness_vec(b_, L, "B", is_real)
        Cv = _eval_witness_vec(b_, L, "Cv", is_real)
        Dv = _eval_witness_vec(b_, L, "Dv", is_real)
        da = _eval_witness_vec(b_, L, "da", is_real)
        E = _eval_witness_vec(b_, L, "E", is_real)
        nx = _eval_witness_vec(b_, L, "nx", is_real)
        dxv = _eval_witness_vec(b_, L, "dxv", is_real)
        ny = _eval_witness_vec(b_, L, "ny", is_real)
        dyv = _eval_witness_vec(b_, L, "dyv", is_real)
        G_A.eval(b_, L, x1, x2, A, is_real)
        G_B.eval(b_, L, y1, y2, B, is_real)
        G_C.eval(b_, L, x1, y2, Cv, is_real)
        G_D.eval(b_, L, x2, y1, Dv, is_real)
        G_DA.eval(b_, L, _D_LIMBS, A, da, is_real)
        G_E.eval(b_, L, da, B, E, is_real)
        G_NX.eval(b_, L, [(1, Cv), (1, Dv), (-1, nx)], is_real)
        G_DX.eval(b_, L, [(1, _ONE), (1, E), (-1, dxv)], is_real, gate=is_real)
        G_NY.eval(b_, L, [(1, A), (1, B), (-1, ny)], is_real)
        G_DY.eval(b_, L, [(1, dyv), (1, E), (-1, _ONE)], is_real, gate=is_real)
        G_MX.eval(b_, L, x3, dxv, nx, is_real)
        G_MY.eval(b_, L, y3, dyv, ny, is_real)
        _eval_lt(b_, L, "x3", x3, P25519, is_real)
        _eval_lt(b_, L, "y3", y3, P25519, is_real)
