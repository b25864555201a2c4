"""ziren_tpu_torch and chip_smoke.py import neither JAX nor anything of
ziren_tpu: the port keeps its own copy of the host layers."""

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
    """In a fresh process, every module of the port and chip_smoke import
    with no module of jax, jaxlib or ziren_tpu loaded."""
    mods = _modules() + ["chip_smoke"]
    assert "ziren_tpu_torch.stark.tprover" in mods and "ziren_tpu_torch.kernels" in mods
    assert "ziren_tpu_torch.machine.mips" in mods and "ziren_tpu_torch.executor.native" in mods
    for m in ("ops.tmerkle", "ops.tntt", "tools.compress_bench", "recursion.deferred",
              "recursion.dsl", "recursion.machine", "recursion.mips_pipeline",
              "recursion.pipeline", "recursion.septic", "recursion.shape_universe",
              "recursion.verifier", "recursion.vk_registry",
              "sdk", "__main__", "install", "network.auth", "network.client",
              "network.service", "network.wire", "verifier.artifacts",
              "verifier.bn254_pairing", "verifier.groth16", "verifier.plonk", "verifier.stark",
              "snark.bn254_curve_native", "snark.circuit", "snark.circuit_outer",
              "snark.contract", "snark.frvec", "snark.groth16", "snark.plonk",
              "snark.wrap_circuit", "guest.abi", "guest.build", "stark.interop",
              "stark.picus", "machine.debug", "stark.tfused",
              "tools.precompile_programs", "tools.kernel_bench", "device", "stark.ici",
              "stark.sharded", "examples", "examples.precompiles", "examples.network_prover",
              "examples.prove_guest", "tools.bench_prove", "tools.profile_prove",
              "tools.profile_device", "tools.device_probe", "tools.groth16_wrap",
              "tools.plonk_wrap", "tools.engine_air", "tools.bench", "tools.memory_programs"):
        assert "ziren_tpu_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ziren_tpu'))\n"
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
    """AST scan: no `import jax...` / `from jax...` and no import of any
    module of ziren_tpu anywhere in the package or chip_smoke.py."""
    forbidden = ("jax", "jaxlib", "ziren_tpu")
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
