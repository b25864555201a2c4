"""DivRemChip: DIV / DIVU / MOD / MODU
(reference: crates/core/machine/src/alu/divrem/mod.rs).

Verifies b = quotient * c + remainder via a synthetic MULT/MULTU
sub-operation (quotient * c with 64-bit result), a 64-bit byte-carry
addition against the sign-extended dividend, |remainder| < |c| via a
synthetic SLTU, and MIPS sign rules (remainder carries the dividend's sign).
DIV/DIVU additionally write the remainder into HI through this chip's
memory access. Division by zero is rejected (the executor traps), enforced
with an inverse witness on c.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import Opcode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, count_u8_word, send_byte, send_u8_word
from .layout import Layout, pad_to_pow2, word_decompose_np
from .memory_access import POS_HI, add_access_cols, eval_access, fill_access
from .messages import instruction_message
from .synthetic import count_rows, emit, merged_rows

P = 2130706433
M32 = 0xFFFFFFFF
OPS = (Opcode.DIV, Opcode.DIVU, Opcode.MOD, Opcode.MODU)

COLS = Layout().add("shard").add("clk")
COLS.add("pc").add("next_pc").add("next_next_pc")
COLS.word("a").word("b").word("c").word("hi")
COLS.add("is_div").add("is_divu").add("is_mod").add("is_modu")
COLS.word("quotient").word("remainder")
COLS.word("mlo").word("mhi")  # quotient * c as 64-bit halves
COLS.add("add_carry", 8)  # carries of (q*c) + sext64(r) == sext64(b)
COLS.add("msb_b").add("msb_c").add("msb_r")  # sign bits (signed ops)
COLS.word("abs_c").word("abs_r")
COLS.add("neg_c_carry", 4).add("neg_r_carry", 4)
COLS.add("r_zero")  # remainder == 0 flag
COLS.add("r_inv", 4).add("r_e", 4).add("r_e01")  # r == 0 gadget
COLS.add("c_nonzero_inv")  # sum of c bytes has an inverse
add_access_cols(COLS, "hi_acc", write=True)
COLS.add("is_real")


def _s32(x):
    x = np.asarray(x, dtype=np.int64)
    return np.where(x >= 1 << 31, x - (1 << 32), x)


class DivRemChip(Air):
    name = "DivRem"
    # r_inv / c_nonzero_inv are free inverse witnesses (not unique): unclassified
    picus_inputs = ("shard", "clk", "pc", "next_pc", "next_next_pc", "b",
                    "c", "is_div", "is_divu", "is_mod", "is_modu", "is_real")
    picus_outputs = ("a", "hi", "quotient", "remainder", "mlo", "mhi",
                     "add_carry", "msb_b", "msb_c", "msb_r", "abs_c",
                     "abs_r", "neg_c_carry", "neg_r_carry", "r_zero",
                     "r_e", "r_e01")
    cycle_chip = True
    width = COLS.width

    def _rows(self, record):
        cols = record.freeze()
        instrs = record.program.instructions
        ops = np.array([int(instrs[i].opcode) for i in cols["instr_idx"]], dtype=np.int64)
        mask = np.isin(ops, [int(o) for o in OPS])
        rows, n_real = merged_rows(record, OPS)
        return cols, mask, rows, n_real

    @staticmethod
    def _qr(rows):
        """quotient, remainder, signedness per row."""
        opm = rows["opcode"]
        signed = np.isin(opm, [int(Opcode.DIV), int(Opcode.MOD)])
        bs = np.where(signed, _s32(rows["b"]), rows["b"])
        cs = np.where(signed, _s32(rows["c"]), rows["c"])
        q = np.zeros(len(opm), dtype=np.int64)
        r = np.zeros(len(opm), dtype=np.int64)
        for i in range(len(opm)):
            bb, cc = int(bs[i]), int(cs[i])
            qq = abs(bb) // abs(cc) if cc != 0 else 0
            if (bb < 0) != (cc < 0):
                qq = -qq
            rr = bb - qq * cc
            q[i] = qq & M32
            r[i] = rr & M32
        return q, r, signed

    def emit_synthetic(self, record):
        rows, _ = merged_rows(record, OPS)
        if len(rows["pc"]) == 0:
            return
        q, r, signed = self._qr(rows)
        for i in range(len(q)):
            prod = (
                int(_s32([q[i]])[0]) * int(_s32([rows["c"][i]])[0])
                if signed[i]
                else int(q[i]) * int(rows["c"][i])
            )
            prod &= (1 << 64) - 1
            mlo, mhi = prod & M32, prod >> 32
            op = Opcode.MULT if signed[i] else Opcode.MULTU
            emit(record, op, mlo, q[i], rows["c"][i], mhi)
            # abs(r) < max(abs(c), 1) via synthetic SLTU
            if signed[i]:
                abs_c = abs(_s32([rows["c"][i]])[0]) & M32
                abs_r = abs(_s32([r[i]])[0]) & M32
            else:
                abs_c, abs_r = int(rows["c"][i]), int(r[i])
            emit(record, Opcode.SLTU, 1, abs_r, max(abs_c, 1))

    def generate_dependencies(self, record, output):
        cols, mask, rows, n_real = self._rows(record)
        n = len(rows["pc"])
        if n == 0:
            return
        opm = rows["opcode"]
        q, r, signed = self._qr(rows)
        signed_i = signed.astype(np.int64)
        bb = word_decompose_np(rows["b"])
        cc = word_decompose_np(rows["c"])
        rb = word_decompose_np(r)
        count(record, B.MSB, bb[:, 3], 0, signed_i)
        count(record, B.MSB, cc[:, 3], 0, signed_i)
        count(record, B.MSB, rb[:, 3], 0, signed_i)
        count_u8_word(record, word_decompose_np(q))
        count_u8_word(record, rb)
        # hi access for DIV/DIVU (real rows only)
        opm_r = opm[:n_real]
        hi_real = np.isin(opm_r, [int(Opcode.DIV), int(Opcode.DIVU)]).astype(np.int64)
        ts = cols["clk"][mask] + POS_HI
        prev_clk = cols["hi_prev_clk"][mask]
        prev_shard = cols["hi_prev_shard"][mask]
        shard = record.public_values.shard
        compare = (prev_shard == shard).astype(np.int64) * hi_real
        diff = (
            np.where(compare == 1, ts - prev_clk - 1, shard - prev_shard - 1)
            * hi_real
        )
        count(record, B.U16Range, diff & 0xFFFF, 0, hi_real)
        count(record, B.U8Range, diff >> 16, 0, hi_real)
        hi_val = word_decompose_np(cols["hi_value"][mask])
        count_u8_word(record, hi_val, hi_real)

    def num_rows(self, record):
        return count_rows(record, OPS)

    def generate_trace(self, record, output):
        cols, mask, rows, n_real = self._rows(record)
        n = len(rows["pc"])
        w = COLS.writer(n)
        opm = rows["opcode"]
        q, r, signed = self._qr(rows)
        hi_real = (
            np.isin(opm, [int(Opcode.DIV), int(Opcode.DIVU)]).astype(np.int64)
        )
        hi_real[n_real:] = 0
        clk_full = np.zeros(n, dtype=np.int64)
        clk_full[:n_real] = cols["clk"][mask]
        w.set("shard", hi_real * record.public_values.shard)
        w.set("clk", clk_full * hi_real)
        for nm in ("pc", "next_pc", "next_next_pc"):
            w.set(nm, rows[nm])
        for nm in ("a", "b", "c"):
            w.set_word(nm, rows[nm])
        w.set_word("hi", rows["prev_a"])
        for op, f in zip(OPS, ("is_div", "is_divu", "is_mod", "is_modu")):
            w.set(f, (opm == int(op)).astype(np.uint32))
        w.set_word("quotient", q)
        w.set_word("remainder", r)
        # synthetic mult product
        prod = np.zeros(n, dtype=object)
        for i in range(n):
            p64 = (
                int(_s32([q[i]])[0]) * int(_s32([rows["c"][i]])[0])
                if signed[i]
                else int(q[i]) * int(rows["c"][i])
            ) & ((1 << 64) - 1)
            prod[i] = p64
        mlo = np.array([int(p) & M32 for p in prod], dtype=np.int64)
        mhi = np.array([int(p) >> 32 for p in prod], dtype=np.int64)
        w.set_word("mlo", mlo)
        w.set_word("mhi", mhi)
        # 64-bit add carries: (mlo,mhi) + sext64(r) == sext64(b)
        msb_r = ((r >> 31) & 1) * signed
        msb_b = ((rows["b"] >> 31) & 1) * signed
        msb_c = ((rows["c"] >> 31) & 1) * signed
        w.set("msb_b", msb_b)
        w.set("msb_c", msb_c)
        w.set("msb_r", msb_r)
        pb = np.concatenate(
            [word_decompose_np(mlo), word_decompose_np(mhi)], axis=1
        ).astype(np.int64)
        rbytes = np.concatenate(
            [word_decompose_np(r), np.tile((255 * msb_r)[:, None], 4)], axis=1
        ).astype(np.int64)
        bbytes = np.concatenate(
            [word_decompose_np(rows["b"]), np.tile((255 * msb_b)[:, None], 4)], axis=1
        ).astype(np.int64)
        carries = np.zeros((n, 8), dtype=np.int64)
        cur = np.zeros(n, dtype=np.int64)
        for k in range(8):
            s = pb[:, k] + rbytes[:, k] + cur
            assert np.all((s & 0xFF) == bbytes[:, k]), "divrem add mismatch"
            cur = s >> 8
            carries[:, k] = cur
        w.set("add_carry", carries)
        # absolute values
        abs_c = np.where(signed, np.abs(_s32(rows["c"])), rows["c"]) & M32
        abs_r = np.where(signed, np.abs(_s32(r)), r) & M32
        w.set_word("abs_c", abs_c)
        w.set_word("abs_r", abs_r)
        for nm, v, m in (("neg_c_carry", rows["c"], abs_c), ("neg_r_carry", r, abs_r)):
            # carries of v + abs == 2^32 when negative (v + abs = 0 mod 2^32)
            vb = word_decompose_np(v).astype(np.int64)
            ab = word_decompose_np(m).astype(np.int64)
            cr = np.zeros((n, 4), dtype=np.int64)
            cur = np.zeros(n, dtype=np.int64)
            for k in range(4):
                s = vb[:, k] + ab[:, k] + cur
                cur = s >> 8
                cr[:, k] = cur
            w.set(nm, cr)
        r_zero = (r == 0).astype(np.uint32)
        w.set("r_zero", r_zero)
        rb = word_decompose_np(r)
        e = (rb == 0).astype(np.uint32)
        w.set("r_e", e)
        w.set("r_e01", e[:, 0] * e[:, 1])
        from ..core.field import finv

        w.set("r_inv", finv(rb.astype(np.uint32)))  # finv(0) == 0
        csum = np.array(
            [int(x) % P for x in (word_decompose_np(rows["c"]).sum(axis=1))]
        )
        w.set(
            "c_nonzero_inv",
            np.array([pow(int(x), P - 2, P) if x else 0 for x in csum]),
        )
        masked = {}
        for k in ("hi_act", "hi_prev_value", "hi_prev_clk", "hi_prev_shard", "hi_value"):
            full = np.zeros(n, dtype=np.int64)
            full[:n_real] = cols[k][mask]
            masked[k] = full * hi_real
        masked["clk"] = clk_full * hi_real
        fill_access(w, masked, "hi", "hi_acc", POS_HI, write=True,
                    shard=record.public_values.shard)
        w.set("is_real", np.ones(n))
        mat = pad_to_pow2(w.mat)
        mat[n:, COLS.slc("r_e")] = 1
        mat[n:, COLS.idx("r_e01")] = 1
        mat[n:, COLS.idx("r_zero")] = 1
        return mat

    def eval(self, b):
        L = COLS.view(b.main_local)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        flags = [L["is_div"], L["is_divu"], L["is_mod"], L["is_modu"]]
        acc = 0
        for f in flags:
            b.assert_bool(f)
            acc = f + acc
        b.assert_eq(acc, is_real)
        opcode = sum(f * int(op) for f, op in zip(flags, OPS))
        is_signed = L["is_div"] + L["is_mod"]
        is_unsigned = L["is_divu"] + L["is_modu"]
        hi_real = L["is_div"] + L["is_divu"]
        b.receive(
            LookupKind.Instruction,
            instruction_message(
                L["shard"], L["clk"], L["pc"], L["next_pc"], L["next_next_pc"],
                opcode, L.word("a"), L.word("b"), L.word("c"), L.word("hi"),
                0, 0, hi_real, 0, 1,
            ),
            is_real,
        )
        a, bw, cw, hi = L.word("a"), L.word("b"), L.word("c"), L.word("hi")
        q, r = L.word("quotient"), L.word("remainder")
        mlo, mhi = L.word("mlo"), L.word("mhi")
        # result routing
        for i in range(4):
            b.when(L["is_div"] + L["is_divu"]).assert_eq(a[i], q[i])
            b.when(L["is_mod"] + L["is_modu"]).assert_eq(a[i], r[i])
            b.when(hi_real).assert_eq(hi[i], r[i])
        send_u8_word(b, q, is_real)
        send_u8_word(b, r, is_real)
        # synthetic multiply: (mlo, mhi) = quotient * c
        b.send(
            LookupKind.Instruction,
            instruction_message(
                0, 0, 1, 5, 9,
                is_signed * int(Opcode.MULT) + is_unsigned * int(Opcode.MULTU),
                mlo, q, cw, mhi, 0, 0, 0, 0, 1,
            ),
            is_real,
        )
        # 64-bit equality: q*c + sext64(r) == sext64(b)
        msb_b, msb_c, msb_r = L["msb_b"], L["msb_c"], L["msb_r"]
        send_byte(b, B.MSB, bw[3], 0, msb_b, is_signed)
        send_byte(b, B.MSB, cw[3], 0, msb_c, is_signed)
        send_byte(b, B.MSB, r[3], 0, msb_r, is_signed)
        b.when(is_unsigned).assert_zero(msb_b)
        b.when(is_unsigned).assert_zero(msb_c)
        b.when(is_unsigned).assert_zero(msb_r)
        pbytes = list(mlo) + list(mhi)
        rext = list(r) + [255 * msb_r] * 4
        bext = list(bw) + [255 * msb_b] * 4
        carry = L["add_carry"]
        prev = 0
        for k in range(8):
            b.assert_bool(carry[k])
            b.assert_zero(pbytes[k] + rext[k] + prev - carry[k] * 256 - bext[k])
            prev = carry[k]
        # absolute values: when negative, v + abs(v) == 2^32 (byte carries);
        # when non-negative, abs(v) == v
        for prefix, v_cols, abs_cols, msb in (
            ("neg_c_carry", cw, L.word("abs_c"), msb_c),
            ("neg_r_carry", r, L.word("abs_r"), msb_r),
        ):
            cr = L[prefix]
            prev = 0
            for k in range(4):
                b.assert_bool(cr[k])
                # negative: bytes of v + abs sum to 0 with final carry 1
                b.when(msb).assert_zero(
                    v_cols[k] + abs_cols[k] + prev - cr[k] * 256
                )
                b.when(1 - msb).assert_eq(abs_cols[k], v_cols[k])
                prev = cr[k]
            b.when(msb).assert_one(cr[3])  # wrapped exactly (v != 0)
        # remainder sign: r == 0 or sign(r) == sign(b)
        e, inv = L["r_e"], L["r_inv"]
        for i in range(4):
            b.assert_bool(e[i])
            b.assert_zero(e[i] * r[i])
            b.assert_zero((1 - e[i]) * (r[i] * inv[i] - 1))
        b.assert_eq(L["r_e01"], e[0] * e[1])
        b.assert_eq(L["r_zero"], L["r_e01"] * (e[2] * e[3]))
        b.when(1 - L["r_zero"]).assert_eq(msb_r * is_signed, msb_b * is_signed)
        # divisor nonzero
        csum = cw[0] + cw[1] + cw[2] + cw[3]
        b.when(is_real).assert_zero(csum * L["c_nonzero_inv"] - 1)
        # |r| < max(|c|, 1) == |c| (c nonzero): synthetic SLTU
        one4 = [1, 0, 0, 0]
        b.send(
            LookupKind.Instruction,
            instruction_message(
                0, 0, 1, 5, 9, int(Opcode.SLTU),
                one4, L.word("abs_r"), L.word("abs_c"), [0, 0, 0, 0],
                0, 0, 0, 0, 1,
            ),
            is_real,
        )
        # HI write for DIV/DIVU
        eval_access(
            b, L, "hi_acc", L["shard"], L["clk"] + POS_HI, 33, hi_real, write=True
        )
        for i in range(4):
            b.when(hi_real).assert_eq(r[i], L.word("hi_acc_value")[i])
        send_u8_word(b, L.word("hi_acc_value"), hi_real)
        b.when(1 - hi_real).assert_zero(L["shard"])
        b.when(1 - hi_real).assert_zero(L["clk"])
