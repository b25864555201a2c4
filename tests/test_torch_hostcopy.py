"""The port's copy of the host layers is the JAX package's, file for file.

ziren_tpu_torch keeps its own copy of every host module it reaches (core,
executor, machine, and the host files of stark), with imports of
`ziren_tpu...` rewritten to relative ones and nothing else changed. Each
copied file is held against its original here, so a repair made on one side
shows up as a difference on the other. Two files differ by design:
stark/machine.py (the device branch of StarkMachine.prove goes to the torch
prover and takes a `device`) and machine/mips.py (prove_program passes
`device` on); their other definitions are compared.
"""

import ast
import os
import re

import pytest

import ziren_tpu
import ziren_tpu_torch

SRC = os.path.dirname(ziren_tpu.__file__)
DST = os.path.dirname(ziren_tpu_torch.__file__)
# files of the port that share a name with one of the JAX package and are
# not copies of it
OWN = {"__init__.py", "ops/__init__.py", "stark/__init__.py", "stark/backend.py"}
BY_DESIGN = {"stark/machine.py": {"StarkMachine", "prove"}, "machine/mips.py": {"prove_program"}}
# one word of a docstring reads otherwise in the copy: (pattern, as copied)
WORDING = {"executor/asm.py": (r"precompile \w+:", "precompile caller:")}


def _copied():
    """Every file of the port that has an original in the JAX package; a
    file without one is the port's own."""
    out = []
    for root, _dirs, names in os.walk(DST):
        for n in names:
            rel = os.path.relpath(os.path.join(root, n), DST).replace(os.sep, "/")
            if n.endswith(".py") and rel not in OWN and os.path.exists(os.path.join(SRC, rel)):
                out.append(rel)
    return sorted(out)


def _rewritten(src: str) -> str:
    src = re.sub(r"^(\s*)from ziren_tpu\.([\w.]+) import", r"\1from ..\2 import", src, flags=re.M)
    return re.sub(r"^(\s*)from ziren_tpu import", r"\1from .. import", src, flags=re.M)


def test_the_copy_is_the_closure():
    copied = _copied()
    for rel in ("core/poseidon2.py", "executor/native.py", "machine/mips.py",
                "stark/prover.py", "stark/verifier.py", "stark/shape.py"):
        assert rel in copied
    # the device layers of the JAX package are ported, never copied
    for rel in ("stark/jprover.py", "stark/jfolder.py", "ops/jposeidon2.py", "sdk.py"):
        assert not os.path.exists(os.path.join(DST, rel)), rel
    assert not [r for r in copied if r.startswith(("ops/", "recursion/", "snark/", "network/"))]


@pytest.mark.parametrize("rel", _copied())
def test_copied_module_matches_original(rel):
    with open(os.path.join(SRC, rel)) as f:
        want = _rewritten(f.read())
    if rel in WORDING:
        want = re.sub(*WORDING[rel], want)
    with open(os.path.join(DST, rel)) as f:
        got = f.read()
    assert "import ziren_tpu" not in got and "from ziren_tpu " not in got
    assert "from ziren_tpu." not in got
    if rel not in BY_DESIGN:
        assert got == want
        return
    skip = BY_DESIGN[rel]

    def defs(text):
        tree = ast.parse(text)
        return {n.name: ast.dump(n) for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name not in skip}

    assert defs(got) == defs(want)
    if rel == "stark/machine.py":  # StarkMachine: every method but prove
        def methods(text):
            cls = next(n for n in ast.parse(text).body
                       if isinstance(n, ast.ClassDef) and n.name == "StarkMachine")
            return {n.name: ast.dump(n) for n in cls.body
                    if isinstance(n, ast.FunctionDef) and n.name != "prove"}

        assert methods(got) == methods(want)
