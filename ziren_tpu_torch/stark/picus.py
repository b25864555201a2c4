"""Picus constraint export: every chip's AIR as a standalone constraint
program for determinism / under-constraint analysis (reference:
crates/picus/src/main.rs + zkm_picus's PicusProgram — each chip compiles
to a module of field equations over named column variables).

`ExprFolder` runs a chip's unchanged eval() pass and CAPTURES the
constraint expressions as ASTs (the 6th folder). `export_chip` serializes
them as s-expressions:

    (prime-number 2130706433)
    (begin-module Cpu)
    (var prep_l0) (var main_l0) (var main_n0) ...
    (assert (= 0 <expr>))          ; one per constraint
    (lookup send Byte (<exprs>) <mult-expr>)
    (end-module)

Input/output classification (which columns a determinism checker treats as
free vs derived) is chip-specific metadata the reference hand-annotates
(PicusInfo); this export declares every column and leaves the split to the
analysis side — tracked in ROADMAP.
"""

from __future__ import annotations

import os

from .folder import _Builder
from .lookup import LookupScope


class EV:
    """Expression-AST folder value."""

    __slots__ = ("fl", "e")

    def __init__(self, fl, e):
        self.fl = fl
        self.e = e

    def __add__(self, o):
        return EV(self.fl, ("+", self.e, self.fl.lift(o).e))

    __radd__ = __add__

    def __sub__(self, o):
        return EV(self.fl, ("-", self.e, self.fl.lift(o).e))

    def __rsub__(self, o):
        return EV(self.fl, ("-", self.fl.lift(o).e, self.e))

    def __mul__(self, o):
        return EV(self.fl, ("*", self.e, self.fl.lift(o).e))

    __rmul__ = __mul__

    def __neg__(self):
        return EV(self.fl, ("-", ("const", 0), self.e))


class ExprFolder(_Builder):
    """Captures a chip's constraints as expression trees."""

    def __init__(self, preprocessed_width, main_width, num_public_values=0):
        super().__init__()
        var = lambda n: EV(self, ("var", n))
        self.prep_local = [var(f"prep_l{i}") for i in range(preprocessed_width)]
        self.prep_next = [var(f"prep_n{i}") for i in range(preprocessed_width)]
        self.main_local = [var(f"main_l{i}") for i in range(main_width)]
        self.main_next = [var(f"main_n{i}") for i in range(main_width)]
        self.public_values = [var(f"pv{i}") for i in range(num_public_values)]
        self.is_first_row = var("sel_first")
        self.is_last_row = var("sel_last")
        self.is_transition = var("sel_transition")
        self.constraints: list = []

    def lift(self, x):
        if isinstance(x, EV):
            return x
        return EV(self, ("const", int(x) % 2130706433))

    def _fold(self, e):
        self.constraints.append(e.e)

    def perm_columns(self, width):
        self.perm_local = [EV(self, ("var", f"perm_l{i}")) for i in range(width)]
        self.perm_next = [EV(self, ("var", f"perm_n{i}")) for i in range(width)]
        return self.perm_local, self.perm_next


def _sexpr(e) -> str:
    kind = e[0]
    if kind == "const":
        return str(e[1])
    if kind == "var":
        return e[1]
    op = {"+": "+", "-": "-", "*": "*"}[kind]
    return f"({op} {_sexpr(e[1])} {_sexpr(e[2])})"


def export_chip(chip, num_public_values: int = 0, strict: bool = True) -> str:
    """One chip -> a Picus-style module (constraints + lookup interface).

    strict: refuse chips without determinism i/o annotations (reference
    derive PicusAnnotations is mandatory per chip) — an unannotated module
    cannot be classified by the determinism checker."""
    if strict and not chip.air.picus_inputs and not chip.air.picus_outputs:
        raise ValueError(
            f"chip {chip.name} has no picus_inputs/picus_outputs "
            "annotations; annotate the Air or pass strict=False")
    fl = ExprFolder(chip.preprocessed_width, chip.width, num_public_values)
    chip.air.eval(fl)

    lines = ["(prime-number 2130706433)", f"(begin-module {chip.name})"]
    names = (
        [f"prep_l{i}" for i in range(chip.preprocessed_width)]
        + [f"prep_n{i}" for i in range(chip.preprocessed_width)]
        + [f"main_l{i}" for i in range(chip.width)]
        + [f"main_n{i}" for i in range(chip.width)]
        + [f"pv{i}" for i in range(num_public_values)]
        + ["sel_first", "sel_last", "sel_transition"]
    )
    lines += [f"(var {n})" for n in names]
    # determinism i/o annotations (reference derive PicusAnnotations):
    # Layout field names -> main_l column indices
    import sys

    layout = getattr(chip.air, "COLS", None)
    if layout is None:  # some chips keep COLS at module level
        layout = getattr(sys.modules[type(chip.air).__module__], "COLS", None)
    for tag, fields in (("picus-input", chip.air.picus_inputs),
                        ("picus-output", chip.air.picus_outputs)):
        for fname in fields:
            s = layout.slc(fname)
            for i in range(s.start, s.stop):
                lines.append(f"({tag} main_l{i})")
    for c in fl.constraints:
        lines.append(f"(assert (= 0 {_sexpr(c)}))")
    for direction, lks in (("send", fl.sends), ("receive", fl.receives)):
        for lk in lks:
            scope = "global" if lk.scope == LookupScope.Global else "local"
            vals = " ".join(_sexpr(v.e) for v in lk.values)
            lines.append(
                f"(lookup {direction} {lk.kind.name} {scope} ({vals}) "
                f"{_sexpr(lk.multiplicity.e)})"
            )
    lines.append("(end-module)")
    return "\n".join(lines) + "\n"


def export_machine(machine, out_dir: str, chips=None) -> list:
    """Write every chip's module to <out_dir>/<Chip>.picus; returns paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for chip in machine.chips:
        if chips and chip.name not in chips:
            continue
        text = export_chip(chip, machine.num_public_values)
        path = os.path.join(out_dir, f"{chip.name}.picus")
        with open(path, "w") as f:
            f.write(text)
        paths.append(path)
    return paths


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Export MIPS chip AIRs to Picus constraint modules "
                    "(reference: crates/picus/src/main.rs)"
    )
    p.add_argument("--chip", action="append", help="chip name (repeatable)")
    p.add_argument("--picus-out-dir", default="picus_out")
    args = p.parse_args(argv)

    from ..machine.mips import mips_machine

    machine = mips_machine()
    paths = export_machine(machine, args.picus_out_dir, chips=args.chip)
    for path in paths:
        print(path)


if __name__ == "__main__":
    main()
