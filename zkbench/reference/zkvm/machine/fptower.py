"""Fp / Fp2 tower-field precompile chips for bn254 and bls12-381
(reference: crates/core/machine/src/syscall/precompiles/fptower/ — FpOpChip,
Fp2AddSubChip, Fp2MulChip, rebuilt on this engine's field gadgets).

One row per event. x lives at x_ptr (overwritten with the result at clk+1),
y is read at clk. Identities over byte limbs:

  fp  add:  x + y - r = b*m          sub:  r + y - x = b*m
  fp  mul:  x*y = r + q*m
  fp2 add/sub: componentwise
  fp2 mul:  t_k = a_i*b_j mod m (4 muls), then
            r0 + t1 - t0 = b*m   and   t2 + t3 - r1 = b*m

Completeness note: inputs are assumed canonical (< m). The executor follows
the reference and reduces non-canonical inputs first; the chip's quotient
witness is sized for canonical operands (the reference FieldOpCols has the
same fixed-limb restriction)."""

from __future__ import annotations

import numpy as np

from ..executor.opcode import SyscallCode
from ..stark.lookup import LookupKind
from .field_gadget import ModLinGadget, ModMulGadget
from .layout import Layout, trace_height
from .memory_access import add_access_cols, eval_access
from .weierstrass import (
    PBLS,
    PBN254,
    _eval_witness_vec,
    _fill_witness_vec,
    _WeierstrassBase,
    _word_limbs,
    _words_to_int,
)

# (name prefix, modulus, words per field element, op, is_fp2, syscall)
FP_OPS = [
    ("Bls12381Fp", PBLS, 12, "add", False, SyscallCode.BLS12381_FP_ADD),
    ("Bls12381Fp", PBLS, 12, "sub", False, SyscallCode.BLS12381_FP_SUB),
    ("Bls12381Fp", PBLS, 12, "mul", False, SyscallCode.BLS12381_FP_MUL),
    ("Bls12381Fp2", PBLS, 12, "add", True, SyscallCode.BLS12381_FP2_ADD),
    ("Bls12381Fp2", PBLS, 12, "sub", True, SyscallCode.BLS12381_FP2_SUB),
    ("Bls12381Fp2", PBLS, 12, "mul", True, SyscallCode.BLS12381_FP2_MUL),
    ("Bn254Fp", PBN254, 8, "add", False, SyscallCode.BN254_FP_ADD),
    ("Bn254Fp", PBN254, 8, "sub", False, SyscallCode.BN254_FP_SUB),
    ("Bn254Fp", PBN254, 8, "mul", False, SyscallCode.BN254_FP_MUL),
    ("Bn254Fp2", PBN254, 8, "add", True, SyscallCode.BN254_FP2_ADD),
    ("Bn254Fp2", PBN254, 8, "sub", True, SyscallCode.BN254_FP2_SUB),
    ("Bn254Fp2", PBN254, 8, "mul", True, SyscallCode.BN254_FP2_MUL),
]


def _make_fp_chip(prefix, modulus, nwf, fop, is_fp2, code):
    nw_el = nwf * (2 if is_fp2 else 1)
    nl = 4 * nwf
    C = Layout().add("shard").add("clk").add("x_ptr").add("y_ptr").add("is_real")
    for i in range(nw_el):
        add_access_cols(C, f"xw{i}", write=True)
    for i in range(nw_el):
        add_access_cols(C, f"yr{i}", write=False)
    gadgets = {}
    if not is_fp2:
        if fop == "mul":
            gadgets["g"] = ModMulGadget(C, "g", modulus, nl)
        else:
            gadgets["g"] = ModLinGadget(C, "g", modulus, nl)
    else:
        if fop == "mul":
            for nm in ("t0", "t1", "t2", "t3"):
                C.add(nm, nl)
            for nm in ("g0", "g1", "g2", "g3"):
                gadgets[nm] = ModMulGadget(C, nm, modulus, nl)
            gadgets["l0"] = ModLinGadget(C, "l0", modulus, nl)
            gadgets["l1"] = ModLinGadget(C, "l1", modulus, nl)
        else:
            gadgets["l0"] = ModLinGadget(C, "l0", modulus, nl)
            gadgets["l1"] = ModLinGadget(C, "l1", modulus, nl)

    class FpChip(_WeierstrassBase):
        picus_inputs = ("shard", "clk", "x_ptr", "y_ptr", "is_real")
        picus_outputs = ()
        name = f"{prefix}{fop.capitalize()}"
        SYSCALL = int(code)
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
            x = [w[1] for w in ev["writes"]]
            y = [r[1] for r in ev["reads"]]
            r_ = [w[4] for w in ev["writes"]]
            if not is_fp2:
                xi, yi, ri = (_words_to_int(v) for v in (x, y, r_))
                if fop == "mul":
                    gadgets["g"].fill(row, C, xi, yi, ri, record)
                elif fop == "add":
                    gadgets["g"].fill(row, C, [(1, xi), (1, yi), (-1, ri)], record)
                else:
                    gadgets["g"].fill(row, C, [(1, ri), (1, yi), (-1, xi)], record)
            else:
                a0, a1 = _words_to_int(x[:nwf]), _words_to_int(x[nwf:])
                b0, b1 = _words_to_int(y[:nwf]), _words_to_int(y[nwf:])
                r0, r1 = _words_to_int(r_[:nwf]), _words_to_int(r_[nwf:])
                if fop == "mul":
                    t0, t1 = (a0 * b0) % m, (a1 * b1) % m
                    t2, t3 = (a0 * b1) % m, (a1 * b0) % m
                    for nm, v in (("t0", t0), ("t1", t1), ("t2", t2), ("t3", t3)):
                        _fill_witness_vec(row, C, nm, v, record, nl=nl)
                    gadgets["g0"].fill(row, C, a0, b0, t0, record)
                    gadgets["g1"].fill(row, C, a1, b1, t1, record)
                    gadgets["g2"].fill(row, C, a0, b1, t2, record)
                    gadgets["g3"].fill(row, C, a1, b0, t3, record)
                    gadgets["l0"].fill(row, C, [(1, r0), (1, t1), (-1, t0)], record)
                    gadgets["l1"].fill(row, C, [(1, t2), (1, t3), (-1, r1)], record)
                elif fop == "add":
                    gadgets["l0"].fill(row, C, [(1, a0), (1, b0), (-1, r0)], record)
                    gadgets["l1"].fill(row, C, [(1, a1), (1, b1), (-1, r1)], record)
                else:
                    gadgets["l0"].fill(row, C, [(1, r0), (1, b0), (-1, a0)], record)
                    gadgets["l1"].fill(row, C, [(1, r1), (1, b1), (-1, a1)], record)
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
                row[C.idx("x_ptr")] = ev["x_ptr"]
                row[C.idx("y_ptr")] = ev["y_ptr"]
                row[C.idx("is_real")] = 1
                for i in range(nw_el):
                    self._fill_access(row, C, f"xw{i}", ev["writes"][i],
                                      ev["clk"] + 1, ev["shard"], True)
                    self._fill_access(row, C, f"yr{i}", ev["reads"][i],
                                      ev["clk"], ev["shard"], False)
            for g in gadgets.values():
                g.fill_padding(mat, C, n)
            return mat

        def eval(self, b_):
            L = C.view(b_.main_local)
            is_real = L["is_real"]
            b_.assert_bool(is_real)
            b_.receive(
                LookupKind.Syscall,
                [L["shard"], L["clk"], self.SYSCALL, L["x_ptr"], L["y_ptr"]],
                is_real,
            )
            for i in range(nw_el):
                eval_access(b_, L, f"yr{i}", L["shard"], L["clk"],
                            L["y_ptr"] + 4 * i, is_real, write=False)
                eval_access(b_, L, f"xw{i}", L["shard"], L["clk"] + 1,
                            L["x_ptr"] + 4 * i, is_real, write=True)
            x = _word_limbs(L, [f"xw{i}_prev_value" for i in range(nw_el)])
            y = _word_limbs(L, [f"yr{i}_value" for i in range(nw_el)])
            r_ = _word_limbs(L, [f"xw{i}_value" for i in range(nw_el)])
            if not is_fp2:
                if fop == "mul":
                    gadgets["g"].eval(b_, L, x, y, r_, is_real)
                elif fop == "add":
                    gadgets["g"].eval(b_, L, [(1, x), (1, y), (-1, r_)], is_real)
                else:
                    gadgets["g"].eval(b_, L, [(1, r_), (1, y), (-1, x)], is_real)
            else:
                a0, a1 = x[: 4 * nwf], x[4 * nwf :]
                b0, b1 = y[: 4 * nwf], y[4 * nwf :]
                r0, r1 = r_[: 4 * nwf], r_[4 * nwf :]
                if fop == "mul":
                    t0 = _eval_witness_vec(b_, L, "t0", is_real, nl=nl)
                    t1 = _eval_witness_vec(b_, L, "t1", is_real, nl=nl)
                    t2 = _eval_witness_vec(b_, L, "t2", is_real, nl=nl)
                    t3 = _eval_witness_vec(b_, L, "t3", is_real, nl=nl)
                    gadgets["g0"].eval(b_, L, a0, b0, t0, is_real)
                    gadgets["g1"].eval(b_, L, a1, b1, t1, is_real)
                    gadgets["g2"].eval(b_, L, a0, b1, t2, is_real)
                    gadgets["g3"].eval(b_, L, a1, b0, t3, is_real)
                    gadgets["l0"].eval(b_, L, [(1, r0), (1, t1), (-1, t0)], is_real)
                    gadgets["l1"].eval(b_, L, [(1, t2), (1, t3), (-1, r1)], is_real)
                elif fop == "add":
                    gadgets["l0"].eval(b_, L, [(1, a0), (1, b0), (-1, r0)], is_real)
                    gadgets["l1"].eval(b_, L, [(1, a1), (1, b1), (-1, r1)], is_real)
                else:
                    gadgets["l0"].eval(b_, L, [(1, r0), (1, b0), (-1, a0)], is_real)
                    gadgets["l1"].eval(b_, L, [(1, r1), (1, b1), (-1, a1)], is_real)

    return FpChip


_CHIP_CLASSES = None


def fptower_chips() -> list:
    global _CHIP_CLASSES
    if _CHIP_CLASSES is None:
        _CHIP_CLASSES = [_make_fp_chip(*s[:5], s[5]) for s in FP_OPS]
    return [cls() for cls in _CHIP_CLASSES]