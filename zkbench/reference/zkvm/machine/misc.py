"""Misc instruction chips: MiscChip (EXT/INS/SEXT/WSBH/TEQ), MovCondChip
(MEQ/MNE), CloClzChip (CLZ/CLO)
(reference: crates/core/machine/src/misc/, alu/clo_clz)."""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import Opcode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, send_byte
from .layout import Layout, pad_to_pow2, word_decompose_np
from .messages import instruction_message
from .synthetic import count_rows, emit, merged_rows

P = 2130706433


def _base_cols(extra_words=("prev_a",)):
    l = Layout().add("pc").add("next_pc").add("next_next_pc")
    l.word("a").word("b").word("c")
    for wname in extra_words:
        l.word(wname)
    return l


def _rows(record, opcodes):
    cols = record.freeze()
    instrs = record.program.instructions
    ops = np.array([int(instrs[i].opcode) for i in cols["instr_idx"]], dtype=np.int64)
    mask = np.isin(ops, [int(o) for o in opcodes])
    return cols, mask, ops


def _fill_base(w, cols, mask, words=("a", "b", "c", "prev_a")):
    for nm in ("pc", "next_pc", "next_next_pc"):
        w.set(nm, cols[nm][mask])
    for nm in words:
        w.set_word(nm, cols[nm][mask])


def _eq_gadget_cols(l: Layout, prefix: str):
    l.add(f"{prefix}_e", 4).add(f"{prefix}_inv", 4).add(f"{prefix}_e01").add(
        f"{prefix}_eq"
    )


def _fill_eq(w, layout, prefix, x_bytes, y_bytes, n):
    e = (x_bytes == y_bytes).astype(np.uint32)
    w.set(f"{prefix}_e", e)
    d = (x_bytes.astype(np.int64) - y_bytes) % P
    w.set(
        f"{prefix}_inv",
        np.array([[pow(int(v), P - 2, P) if v else 0 for v in row] for row in d]),
    )
    w.set(f"{prefix}_e01", e[:, 0] * e[:, 1])
    w.set(f"{prefix}_eq", e.all(axis=1).astype(np.uint32))


def _pad_eq(mat, layout, prefix, n):
    mat[n:, layout.slc(f"{prefix}_e")] = 1
    mat[n:, layout.idx(f"{prefix}_e01")] = 1
    mat[n:, layout.idx(f"{prefix}_eq")] = 1


def _eval_eq(b, L, prefix, x_cols, y_cols):
    """Constrains {prefix}_eq == (x word == y word). Returns the eq value."""
    e = L[f"{prefix}_e"]
    inv = L[f"{prefix}_inv"]
    for i in range(4):
        d = x_cols[i] - y_cols[i] if y_cols is not None else x_cols[i]
        b.assert_bool(e[i])
        b.assert_zero(e[i] * d)
        b.assert_zero((1 - e[i]) * (d * inv[i] - 1))
    b.assert_eq(L[f"{prefix}_e01"], e[0] * e[1])
    b.assert_eq(L[f"{prefix}_eq"], L[f"{prefix}_e01"] * (e[2] * e[3]))
    return L[f"{prefix}_eq"]


def _ins_intermediates(a, b, prev_a, c):
    """INS sub-operation values (reference: misc/others/air.rs eval_ins)."""
    msb, lsb = int(c) >> 5, int(c) & 31
    w = msb - lsb + 1
    rotr = lambda x, s: ((x >> s) | (x << (32 - s))) & 0xFFFFFFFF if s else x
    ror_val = rotr(int(prev_a), lsb)
    srl1 = ror_val >> 1
    srl_val = srl1 >> (msb - lsb)
    sll_val = (int(b) << (31 - msb + lsb)) & 0xFFFFFFFF
    add_val = (srl_val + sll_val) & 0xFFFFFFFF
    return msb, lsb, ror_val, srl1, srl_val, sll_val, add_val


class MiscChip(Air):
    """SEXT (SEB/SEH), WSBH, TEQ, EXT, INS. EXT/INS decompose into synthetic
    shift/add sub-operations (reference: misc/others/air.rs eval_ext/eval_ins)."""

    name = "MiscInstrs"
    # ab_inv is a free inverse witness: unclassified
    picus_inputs = ("pc", "next_pc", "next_next_pc", "b", "c", "prev_a",
                    "is_sext", "is_wsbh", "is_teq", "is_ext", "is_ins",
                    "is_real")
    picus_outputs = ("a", "sel", "msb", "ab_e", "ab_e01", "ab_eq", "lsb",
                     "msbd", "sll_val", "ror_val", "srl1_val", "srl_val",
                     "add_val")
    cycle_chip = True
    OPS = (Opcode.SEXT, Opcode.WSBH, Opcode.TEQ, Opcode.EXT, Opcode.INS)
    COLS = _base_cols()
    COLS.add("is_sext").add("is_wsbh").add("is_teq").add("is_ext").add("is_ins")
    COLS.add("sel").add("msb")
    _eq_gadget_cols(COLS, "ab")  # TEQ: a != b
    COLS.add("lsb").add("msbd")  # EXT/INS bitfield parameters
    COLS.word("sll_val")
    COLS.word("ror_val").word("srl1_val").word("srl_val").word("add_val")
    COLS.add("is_real")
    width = COLS.width

    def emit_synthetic(self, record):
        cols, mask, ops = _rows(record, self.OPS)
        opm = ops[mask]
        a = cols["a"][mask]
        bb = cols["b"][mask]
        cc = cols["c"][mask]
        pa = cols["prev_a"][mask]
        for i in range(len(opm)):
            if opm[i] == int(Opcode.EXT):
                msbd, lsb = int(cc[i]) >> 5, int(cc[i]) & 31
                sll_val = (int(bb[i]) << (31 - lsb - msbd)) & 0xFFFFFFFF
                emit(record, Opcode.SLL, sll_val, bb[i], 31 - lsb - msbd)
                emit(record, Opcode.SRL, a[i], sll_val, 31 - msbd)
            elif opm[i] == int(Opcode.INS):
                msb, lsb, ror_val, srl1, srl_val, sll_val, add_val = (
                    _ins_intermediates(a[i], bb[i], pa[i], cc[i])
                )
                emit(record, Opcode.ROR, ror_val, pa[i], lsb)
                emit(record, Opcode.SRL, srl1, ror_val, 1)
                emit(record, Opcode.SRL, srl_val, srl1, msb - lsb)
                emit(record, Opcode.SLL, sll_val, bb[i], 31 - msb + lsb)
                emit(record, Opcode.ADD, add_val, srl_val, sll_val)
                emit(record, Opcode.ROR, a[i], add_val, 31 - msb)

    def generate_dependencies(self, record, output):
        cols, mask, ops = _rows(record, self.OPS)
        n = int(mask.sum())
        if n == 0:
            return
        opm = ops[mask]
        bb = word_decompose_np(cols["b"][mask])
        c0 = cols["c"][mask] & 1
        sel = np.where(c0 == 1, bb[:, 1], bb[:, 0])
        count(record, B.MSB, sel, 0, (opm == int(Opcode.SEXT)).astype(np.int64))
        cc = cols["c"][mask]
        lsb = cc & 31
        msbd = cc >> 5
        is_ext = (opm == int(Opcode.EXT)).astype(np.int64)
        is_ins = (opm == int(Opcode.INS)).astype(np.int64)
        count(record, B.U8Range, lsb, msbd, is_ext + is_ins)
        count(record, B.LTU, lsb + msbd, 32, is_ext)
        count(record, B.LTU, msbd, 32, is_ins)
        count(record, B.LTU, msbd, lsb, is_ins)  # msb >= lsb -> result 0

    def num_rows(self, record):
        return count_rows(record, self.OPS)

    def generate_trace(self, record, output):
        cols, mask, ops = _rows(record, self.OPS)
        n = int(mask.sum())
        w = self.COLS.writer(n)
        _fill_base(w, cols, mask)
        opm = ops[mask]
        w.set("is_sext", (opm == int(Opcode.SEXT)).astype(np.uint32))
        w.set("is_wsbh", (opm == int(Opcode.WSBH)).astype(np.uint32))
        w.set("is_teq", (opm == int(Opcode.TEQ)).astype(np.uint32))
        w.set("is_ext", (opm == int(Opcode.EXT)).astype(np.uint32))
        w.set("is_ins", (opm == int(Opcode.INS)).astype(np.uint32))
        bb = word_decompose_np(cols["b"][mask])
        c0 = cols["c"][mask] & 1
        sel = np.where(c0 == 1, bb[:, 1], bb[:, 0])
        w.set("sel", sel * (opm == int(Opcode.SEXT)))
        w.set("msb", ((sel >> 7) & 1) * (opm == int(Opcode.SEXT)))
        ab_a = word_decompose_np(cols["a"][mask])
        _fill_eq(w, self.COLS, "ab", ab_a, bb, n)
        cc = cols["c"][mask]
        extins = np.isin(opm, [int(Opcode.EXT), int(Opcode.INS)])
        w.set("lsb", (cc & 31) * extins)
        w.set("msbd", (cc >> 5) * extins)
        slls = np.zeros(n, dtype=np.int64)
        rors = np.zeros(n, dtype=np.int64)
        srl1s = np.zeros(n, dtype=np.int64)
        srls = np.zeros(n, dtype=np.int64)
        adds = np.zeros(n, dtype=np.int64)
        for i in range(n):
            if opm[i] == int(Opcode.EXT):
                msbd, lsb = int(cc[i]) >> 5, int(cc[i]) & 31
                slls[i] = (int(cols["b"][mask][i]) << (31 - lsb - msbd)) & 0xFFFFFFFF
            elif opm[i] == int(Opcode.INS):
                _, _, ror_val, srl1, srl_val, sll_val, add_val = _ins_intermediates(
                    cols["a"][mask][i], cols["b"][mask][i],
                    cols["prev_a"][mask][i], cc[i],
                )
                rors[i], srl1s[i], srls[i] = ror_val, srl1, srl_val
                slls[i], adds[i] = sll_val, add_val
        w.set_word("sll_val", slls)
        w.set_word("ror_val", rors)
        w.set_word("srl1_val", srl1s)
        w.set_word("srl_val", srls)
        w.set_word("add_val", adds)
        w.set("is_real", np.ones(n))
        mat = pad_to_pow2(w.mat)
        _pad_eq(mat, self.COLS, "ab", n)
        return mat

    def eval(self, b):
        L = self.COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        flags = [L["is_sext"], L["is_wsbh"], L["is_teq"], L["is_ext"], L["is_ins"]]
        acc = 0
        for f in flags:
            b.assert_bool(f)
            acc = f + acc
        b.assert_eq(acc, is_real)
        opcode = sum(f * int(o) for f, o in zip(flags, self.OPS))
        is_teq = L["is_teq"]
        b.receive(
            LookupKind.Instruction,
            instruction_message(
                0, 0, L["pc"], L["next_pc"], L["next_next_pc"], opcode,
                L.word("a"), L.word("b"), L.word("c"), L.word("prev_a"),
                is_teq, L["is_ins"], 0, 0, 1,
            ),
            is_real,
        )
        a, bw, c = L.word("a"), L.word("b"), L.word("c")
        # SEXT: c in {0 (SEB), 1 (SEH)}
        sext = L["is_sext"]
        b.when(sext).assert_bool(c[0])
        for i in (1, 2, 3):
            b.when(sext).assert_zero(c[i])
        sel = L["sel"]
        b.when(sext).assert_eq(sel, (1 - c[0]) * bw[0] + c[0] * bw[1])
        send_byte(b, B.MSB, sel, 0, L["msb"], sext)
        b.when(sext).assert_eq(a[0], bw[0])
        # SEB: a1 = 255*msb; SEH: a1 = b1
        b.when(sext).assert_eq(a[1], c[0] * bw[1] + (1 - c[0]) * 255 * L["msb"])
        b.when(sext).assert_eq(a[2], 255 * L["msb"])
        b.when(sext).assert_eq(a[3], 255 * L["msb"])
        # WSBH: a = [b1, b0, b3, b2]
        wsbh = L["is_wsbh"]
        b.when(wsbh).assert_eq(a[0], bw[1])
        b.when(wsbh).assert_eq(a[1], bw[0])
        b.when(wsbh).assert_eq(a[2], bw[3])
        b.when(wsbh).assert_eq(a[3], bw[2])
        # TEQ: trap when equal -> valid traces require a != b
        eq = _eval_eq(b, L, "ab", a, bw)
        b.when(is_teq).assert_zero(eq)

        # EXT / INS: bitfield parameter binding + synthetic sub-operations
        from .layout import pack_word

        is_ext, is_ins = L["is_ext"], L["is_ins"]
        extins = is_ext + is_ins
        lsb, msbd = L["lsb"], L["msbd"]
        b.when(extins).assert_eq(pack_word(c), lsb + msbd * 32)
        send_byte(b, B.U8Range, lsb, msbd, 0, extins)
        send_byte(b, B.LTU, lsb + msbd, 32, 1, is_ext)
        send_byte(b, B.LTU, msbd, 32, 1, is_ins)
        send_byte(b, B.LTU, msbd, lsb, 0, is_ins)  # msb >= lsb
        zero4 = [0, 0, 0, 0]
        def synth(op, av, bv, cv, mult):
            cw = cv if isinstance(cv, list) else [cv, 0, 0, 0]
            b.send(
                LookupKind.Instruction,
                instruction_message(
                    0, 0, 1, 5, 9, int(op), av, bv, cw, zero4, 0, 0, 0, 0, 1
                ),
                mult,
            )
        sll_val = L.word("sll_val")
        # EXT: a = (b << (31 - lsb - msbd)) >> (31 - msbd)
        synth(Opcode.SLL, sll_val, bw, 31 - lsb - msbd, is_ext)
        synth(Opcode.SRL, a, sll_val, 31 - msbd, is_ext)
        # INS: see _ins_intermediates
        prev_a = L.word("prev_a")
        ror_val, srl1_val = L.word("ror_val"), L.word("srl1_val")
        srl_val, add_val = L.word("srl_val"), L.word("add_val")
        synth(Opcode.ROR, ror_val, prev_a, lsb, is_ins)
        synth(Opcode.SRL, srl1_val, ror_val, 1, is_ins)
        synth(Opcode.SRL, srl_val, srl1_val, msbd - lsb, is_ins)
        synth(Opcode.SLL, sll_val, bw, 31 - msbd + lsb, is_ins)
        synth(Opcode.ADD, add_val, srl_val, sll_val, is_ins)
        synth(Opcode.ROR, a, add_val, 31 - msbd, is_ins)


class MovCondChip(Air):
    """MEQ (MOVZ): a = (c == 0) ? b : prev_a; MNE (MOVN): inverse."""

    name = "MovCond"
    # cz_inv is a free inverse witness: unclassified
    picus_inputs = ("pc", "next_pc", "next_next_pc", "b", "c", "prev_a",
                    "is_meq", "is_mne", "is_real")
    picus_outputs = ("a", "mov", "cz_e", "cz_e01", "cz_eq")
    cycle_chip = True
    OPS = (Opcode.MEQ, Opcode.MNE)
    COLS = _base_cols()
    COLS.add("is_meq").add("is_mne").add("mov")
    _eq_gadget_cols(COLS, "cz")  # c == 0
    COLS.add("is_real")
    width = COLS.width

    def num_rows(self, record):
        return count_rows(record, self.OPS)

    def generate_trace(self, record, output):
        cols, mask, ops = _rows(record, self.OPS)
        n = int(mask.sum())
        w = self.COLS.writer(n)
        _fill_base(w, cols, mask)
        opm = ops[mask]
        is_meq = (opm == int(Opcode.MEQ)).astype(np.uint32)
        w.set("is_meq", is_meq)
        w.set("is_mne", 1 - is_meq)
        cc = word_decompose_np(cols["c"][mask])
        _fill_eq(w, self.COLS, "cz", cc, np.zeros_like(cc), n)
        zc = (cols["c"][mask] == 0).astype(np.uint32)
        w.set("mov", np.where(is_meq == 1, zc, 1 - zc))
        w.set("is_real", np.ones(n))
        mat = pad_to_pow2(w.mat)
        _pad_eq(mat, self.COLS, "cz", n)
        return mat

    def eval(self, b):
        L = self.COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        is_meq, is_mne = L["is_meq"], L["is_mne"]
        b.assert_bool(is_meq)
        b.assert_bool(is_mne)
        b.assert_eq(is_meq + is_mne, is_real)
        opcode = is_meq * int(Opcode.MEQ) + is_mne * int(Opcode.MNE)
        b.receive(
            LookupKind.Instruction,
            instruction_message(
                0, 0, L["pc"], L["next_pc"], L["next_next_pc"], opcode,
                L.word("a"), L.word("b"), L.word("c"), L.word("prev_a"),
                0, is_real, 0, 0, 1,
            ),
            is_real,
        )
        a, bw, c, prev_a = L.word("a"), L.word("b"), L.word("c"), L.word("prev_a")
        zc = _eval_eq(b, L, "cz", c, None)
        mov = L["mov"]
        b.assert_bool(mov)
        b.when(is_meq).assert_eq(mov, zc)
        b.when(is_mne).assert_eq(mov, 1 - zc)
        for i in range(4):
            b.when(is_real).assert_eq(a[i], mov * bw[i] + (1 - mov) * prev_a[i])


class CloClzChip(Air):
    """CLZ/CLO: count leading zeros/ones via a first-nonzero-byte scan and a
    per-byte CLZ lookup (custom byte-table op; deviation from the reference's
    bit-decomposition documented here)."""

    name = "CloClz"
    # sel_inv is a free inverse witness: unclassified
    picus_inputs = ("pc", "next_pc", "next_next_pc", "b", "c", "is_clz",
                    "is_clo", "is_real")
    picus_outputs = ("a", "g", "all_zero", "sel", "clz_sel")
    cycle_chip = True
    OPS = (Opcode.CLZ, Opcode.CLO)
    COLS = _base_cols(extra_words=())
    COLS.add("is_clz").add("is_clo")
    COLS.add("g", 4)  # one-hot: most significant nonzero (adjusted) byte
    COLS.add("all_zero")
    COLS.add("sel")  # the flagged adjusted byte
    COLS.add("sel_inv")
    COLS.add("clz_sel")  # clz of the flagged byte
    COLS.add("is_real")
    width = COLS.width

    @staticmethod
    def _adjusted(bb, opm):
        return np.where(
            (opm == int(Opcode.CLO))[:, None], 255 - bb, bb
        ).astype(np.int64)

    def generate_dependencies(self, record, output):
        cols, mask, ops = _rows(record, self.OPS)
        n = int(mask.sum())
        if n == 0:
            return
        u = self._adjusted(word_decompose_np(cols["b"][mask]), ops[mask])
        sel = np.zeros(n, dtype=np.int64)
        nz = np.zeros(n, dtype=np.int64)
        for r in range(n):
            for i in (3, 2, 1, 0):
                if u[r, i] != 0:
                    sel[r] = u[r, i]
                    nz[r] = 1
                    break
        count(record, B.CLZ8, sel, 0, nz)

    def num_rows(self, record):
        return count_rows(record, self.OPS)

    def generate_trace(self, record, output):
        cols, mask, ops = _rows(record, self.OPS)
        n = int(mask.sum())
        w = self.COLS.writer(n)
        _fill_base(w, cols, mask, words=("a", "b", "c"))
        opm = ops[mask]
        is_clz = (opm == int(Opcode.CLZ)).astype(np.uint32)
        w.set("is_clz", is_clz)
        w.set("is_clo", 1 - is_clz)
        u = self._adjusted(word_decompose_np(cols["b"][mask]), opm)
        g = np.zeros((n, 4), dtype=np.uint32)
        sel = np.zeros(n, dtype=np.int64)
        clz_sel = np.zeros(n, dtype=np.int64)
        all_zero = np.ones(n, dtype=np.uint32)
        for r in range(n):
            for i in (3, 2, 1, 0):
                if u[r, i] != 0:
                    g[r, i] = 1
                    sel[r] = u[r, i]
                    clz_sel[r] = 8 - int(u[r, i]).bit_length()
                    all_zero[r] = 0
                    break
        w.set("g", g)
        w.set("all_zero", all_zero)
        w.set("sel", sel)
        w.set(
            "sel_inv",
            np.array([pow(int(x), P - 2, P) if x else 0 for x in sel]),
        )
        w.set("clz_sel", clz_sel)
        w.set("is_real", np.ones(n))
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = self.COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        is_clz, is_clo = L["is_clz"], L["is_clo"]
        b.assert_bool(is_clz)
        b.assert_bool(is_clo)
        b.assert_eq(is_clz + is_clo, is_real)
        opcode = is_clz * int(Opcode.CLZ) + is_clo * int(Opcode.CLO)
        b.receive(
            LookupKind.Instruction,
            instruction_message(
                0, 0, L["pc"], L["next_pc"], L["next_next_pc"], opcode,
                L.word("a"), L.word("b"), L.word("c"), [0, 0, 0, 0],
                0, 0, 0, 0, 1,
            ),
            is_real,
        )
        a, bw = L.word("a"), L.word("b")
        # adjusted bytes u_i = clz ? b_i : 255 - b_i
        u = [is_clz * bw[i] + is_clo * (255 - bw[i]) for i in range(4)]
        g, az = L["g"], L["all_zero"]
        acc = az
        for i in range(4):
            b.assert_bool(g[i])
            acc = acc + g[i]
        b.assert_bool(az)
        b.when(is_real).assert_one(acc)
        # bytes above the flagged byte are zero; all_zero -> all bytes zero
        for i in range(4):
            zero_needed = az
            for j in range(i):
                zero_needed = zero_needed + g[j]
            b.assert_zero(zero_needed * u[i])
        # the flagged byte is sel and nonzero
        for i in range(4):
            b.assert_zero(g[i] * (L["sel"] - u[i]))
        gsum = g[0] + g[1] + g[2] + g[3]
        b.when(gsum).assert_zero(L["sel"] * L["sel_inv"] - 1)
        send_byte(b, B.CLZ8, L["sel"], 0, L["clz_sel"], gsum)
        # result: a = 8*(3 - flagged index) + clz(sel), or 32 if all zero
        expr = az * 32 + L["clz_sel"] * gsum
        for i in range(4):
            expr = expr + g[i] * (8 * (3 - i))
        b.when(is_real).assert_eq(a[0], expr)
        for i in (1, 2, 3):
            b.assert_zero(a[i])
