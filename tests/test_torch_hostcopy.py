"""The port's copy of the host layers is the JAX package's, file for file.

ziren_tpu_torch keeps its own copy of every host module it reaches (core,
executor, machine, recursion, the host files of stark, verifier, snark,
network, guest, the SDK and the CLI), with imports of `ziren_tpu...`
rewritten to relative ones and nothing else changed. Each copied file is
held against its original here, so a repair made on one side shows up as a
difference on the other. A few files differ by design, in the functions and
methods BY_DESIGN names and nowhere else: stark/machine.py (the device
branch of StarkMachine.prove goes to the torch prover and takes a `device`,
or `devices`, a mesh whose members take the shards in turn, as the JAX
package's `devices` does; under ZIREN_FUSED=1 a `device` prove goes to
stark/tfused.py, the port of stark/fused.py, as the JAX package's
StarkMachine.prove goes to fused.py),
machine/mips.py (prove_program passes `device` on;
prove_program_checkpointed takes `device` and proves its shards in order on
the calling thread with the torch shard prover, the workers regenerating
the next shards' records and traces, or with the numpy prover in the
workers under "host"), the recursion entry
points that prove (they take `device` and pass it on to StarkMachine.prove;
wrap_bn254 names the host prover, the only one its config has),
recursion/shape_universe.py (its registry cache is keyed by the port's own
sources and lies in the port's build directory), sdk.py (ProverClient keeps
a `device` and hands it to every STARK prove; create_prover's in-process
modes are "cuda" / "local" for the GPU and "cpu" by name), network/ (the
service and the server take `device`; the client, which only sets up and
verifies, is a plain copy; the wire's allowlist names this package, takes no
dotted name and takes only a class that the package defines itself; the
request verifier tests and records a nonce under one lock, so that two
threaded copies of a signed request cannot both pass),
__main__.py (the program's name, `--device`),
guest/build.py (include_elf searches ZIREN_ELF_PATH and the caller's root,
and no fixed directory outside them), and machine/global_chip.py (the
running sum of the Global chip's trace, the same values, in Python ints
packed into big ints where the original calls numpy on seven-element
vectors: the host's longest trace on a memory shard).
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
OWN = {"__init__.py", "ops/__init__.py", "stark/__init__.py", "stark/backend.py",
       "stark/ici.py", "stark/sharded.py"}
# a name with a dot is a method: the rest of its class is held
BY_DESIGN = {
    "stark/machine.py": {"StarkMachine.prove", "prove"},
    "machine/mips.py": {"prove_program", "prove_program_checkpointed"},
    "recursion/machine.py": {"prove_recursion"},
    "recursion/pipeline.py": {"_prove_cached", "lift", "join", "compress", "shrink",
                              "wrap_bn254"},
    "recursion/mips_pipeline.py": {"lift_shard", "join", "compress"},
    "recursion/deferred.py": {"deferred_leaf", "deferred_join", "deferred_chain",
                              "attach_deferred"},
    "recursion/shape_universe.py": {"_registry_cache_path"},
    "sdk.py": {"create_prover", "ProverClient.__init__", "ProverClient.prove",
               "ProverClient.compressed_prove", "ProverClient.shrink_prove"},
    "network/wire.py": {"_RestrictedUnpickler.find_class"},
    "network/service.py": {"ProverService.__init__", "ProverServer.__init__"},
    "network/auth.py": {"RequestVerifier.__init__", "RequestVerifier.verify"},
    "__main__.py": {"_client", "_scaffold_guest", "main"},
    "guest/build.py": {"include_elf"},
    "machine/global_chip.py": {"GlobalChip.generate_trace", "_running_sums"},
}
# by-design files whose module docstring names the port, and the
# module-level names that the port adds or gives another value
OWN_DOCSTRING = {"sdk.py", "network/wire.py", "__main__.py"}
OWN_ASSIGNS = {"network/wire.py": {"_PACKAGE"}, "guest/build.py": {"_ELF_SEARCH"}}
# and the modules that a by-design file imports besides the original's
OWN_IMPORTS = {"network/auth.py": {"threading"}}
# the files of the JAX package that are ported under another name, or never
# ported: stark/fused.py is ported as stark/tfused.py (one CUDA graph per
# shard shape), stark/aot.py stays unported by design (the jax.export disk
# cache of fused.py's executables: a CUDA graph cannot be written to disk);
# stark/sharded.py and stark/ici.py are ported under their own names (OWN:
# over a mesh of members, ziren_tpu_torch/device.py)
NOT_COPIED = {*[f"ops/j{m}.py" for m in ("challenger", "field", "merkle", "ntt", "pcs",
                                          "poseidon2")],
              *[f"stark/{m}.py" for m in ("jprover", "jfolder", "fused", "aot")]}
RECURSION = ("__init__", "deferred", "dsl", "machine", "mips_pipeline", "pipeline", "septic",
             "shape_universe", "verifier", "vk_registry")
# one word of a docstring reads otherwise in the copy: (pattern, as copied)
WORDING = {"executor/asm.py": (r"precompile \w+:", "precompile caller:"),
           "recursion/pipeline.py": (r"^\"\"\"Recursion pipeline \w+:",
                                     '"""Recursion pipeline entry points:'),
           # an import line in a docstring, spelled out as a user types it
           "verifier/__init__.py": (r"from \.\.verifier import Groth16Verifier",
                                    "from ziren_tpu_torch.verifier import Groth16Verifier")}


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


def _rewritten(src: str, rel: str) -> str:
    dots = "." * (rel.count("/") + 1)  # a file of the package itself: one dot
    src = re.sub(r"^(\s*)from ziren_tpu\.([\w.]+) import", rf"\1from {dots}\2 import", src,
                 flags=re.M)
    return re.sub(r"^(\s*)from ziren_tpu import", rf"\1from {dots} import", src, flags=re.M)


def _py_files(pkg):
    out = set()
    for root, _dirs, names in os.walk(pkg):
        out |= {os.path.relpath(os.path.join(root, n), pkg).replace(os.sep, "/")
                for n in names if n.endswith(".py")}
    return out


def test_the_copy_is_the_closure():
    copied = _copied()
    for rel in ("core/poseidon2.py", "executor/native.py", "machine/mips.py",
                "stark/prover.py", "stark/verifier.py", "stark/shape.py",
                *[f"recursion/{m}.py" for m in RECURSION if m != "__init__"]):
        assert rel in copied
    for pkg in (SRC, DST):  # the whole sub-package, module for module
        found = sorted(n for n in os.listdir(os.path.join(pkg, "recursion")) if n.endswith(".py"))
        assert found == sorted(f"{m}.py" for m in RECURSION), pkg
    # the device layers of the JAX package are ported, never copied
    for rel in NOT_COPIED:
        assert os.path.exists(os.path.join(SRC, rel)), rel
        assert not os.path.exists(os.path.join(DST, rel)), rel
    assert not [r for r in copied if r.startswith("ops/")]
    # every other file of the JAX package has its counterpart in the port
    assert _py_files(SRC) - NOT_COPIED <= _py_files(DST)
    assert _py_files(SRC) - NOT_COPIED - OWN == set(copied)
    for sub in ("verifier", "snark", "network", "guest"):
        assert sum(r.startswith(sub + "/") for r in copied) == len(
            [n for n in os.listdir(os.path.join(SRC, sub)) if n.endswith(".py")])


@pytest.mark.parametrize("rel", _copied())
def test_copied_module_matches_original(rel):
    with open(os.path.join(SRC, rel)) as f:
        want = _rewritten(f.read(), rel)
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
        out = {}
        for n in ast.parse(text).body:
            if not isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                continue
            if any(s.startswith(n.name + ".") for s in skip):  # a class, method by method
                out[n.name] = ast.dump(ast.ClassDef(n.name, n.bases, n.keywords, [],
                                                    n.decorator_list))
                for m in n.body:
                    key = f"{n.name}.{getattr(m, 'name', None) or ast.dump(m)}"
                    if key not in skip:
                        out[key] = ast.dump(m)
            elif n.name not in skip:
                out[n.name] = ast.dump(n)
        return out

    assert defs(got) == defs(want)
    if rel not in ("stark/machine.py", "machine/mips.py"):
        # everything outside a function or class is the same
        def rest(text):
            body = ast.parse(text).body
            if rel in OWN_DOCSTRING:
                assert ast.get_docstring(ast.parse(text))
                body = body[1:]
            return [ast.dump(n) for n in body
                    if not isinstance(n, (ast.FunctionDef, ast.ClassDef))
                    and not (isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
                             and n.targets[0].id in OWN_ASSIGNS.get(rel, ()))
                    and not (isinstance(n, ast.Import)
                             and {a.name for a in n.names} <= OWN_IMPORTS.get(rel, set()))]

        assert rest(got) == rest(want)
    if rel.startswith("recursion/"):
        # what differs takes `device`
        tree = ast.parse(got)
        for n in tree.body:
            if isinstance(n, ast.FunctionDef) and n.name in skip - {"wrap_bn254",
                                                                   "_registry_cache_path"}:
                assert "device" in [a.arg for a in n.args.args + n.args.kwonlyargs], n.name
    takes_device = {"sdk.py": ("ProverClient", "__init__"),
                    "network/service.py": ("ProverService", "__init__")}
    if rel in takes_device:
        cls, method = takes_device[rel]
        node = next(m for n in ast.parse(got).body if isinstance(n, ast.ClassDef)
                    and n.name == cls for m in n.body
                    if isinstance(m, ast.FunctionDef) and m.name == method)
        assert "device" in [a.arg for a in node.args.args], rel
