"""ziren_tpu_torch never imports JAX, directly or through ziren_tpu."""

import ast
import os
import pkgutil
import subprocess
import sys

import ziren_tpu_torch

PKG_DIR = os.path.dirname(ziren_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    names = ["ziren_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], prefix="ziren_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "ziren_tpu_torch.stark.tprover" in mods and "ziren_tpu_torch.kernels" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


def test_no_jax_import_statements():
    """AST scan: no `import jax...` / `from jax...` and no import of the
    JAX-backed modules of ziren_tpu anywhere in the package or chip_smoke.py."""
    forbidden = ("jax", "ziren_tpu.ops", "ziren_tpu.stark.jprover",
                 "ziren_tpu.stark.jfolder", "ziren_tpu.stark.aot",
                 "ziren_tpu.stark.backend", "ziren_tpu.stark.fused",
                 "ziren_tpu.stark.sharded", "ziren_tpu.stark.ici")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                # `from ziren_tpu.stark import jprover` names the module too
                mods = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for m in mods:
                if any(m == f or m.startswith(f + ".") for f in forbidden):
                    hits.append((path, node.lineno, m))
    assert not hits, hits
