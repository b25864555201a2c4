"""The port's drivers against the JAX repo's scripts, on the CPU.

Each driver of ziren_tpu_torch/tools and ziren_tpu_torch/examples runs in
this process through its command line with `--device cpu` (the kernels'
plain versions), and the JAX script it ports (tools/, examples/) through
runpy with sys.argv set, on a CPU-only JAX, where ziren_tpu proves with its
host prover. What both print is compared with timings left out, and the
proofs' bytes where the driver hands its proof back (the JAX script's is
caught where its package returns it). Left without `--device`, a driver
means the GPU and raises where there is none. Four drivers have files of
their own, so that no file takes much more than a minute and a half of one
worker: tests/test_torch_drivers_examples.py (precompiles, network_prover),
_profile.py (profile_prove), _legs.py (profile_device) and _probe.py
(device_probe); the checkpointed prove's is tests/test_torch_checkpoint.py.
"""

import contextlib
import json
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

import ziren_tpu.machine.mips as jmips
import ziren_tpu.sdk as jsdk
from chip_smoke import minimal_elf
from test_stark_engine import FibonacciAir as JFibonacciAir
from test_stark_engine import Record as JRecord
from test_stark_engine import fib_pv as jfib_pv
from ziren_tpu.stark.config import dev_config as jdev_config
from ziren_tpu.stark.machine import StarkMachine as JStarkMachine
from ziren_tpu.stark.serialize import serialize_machine_proof as jserialize
from ziren_tpu_torch.examples import network_prover, precompiles, prove_guest
from ziren_tpu_torch.sdk import ProverClient
from ziren_tpu_torch.stark.config import dev_config
from ziren_tpu_torch.stark.machine import StarkMachine
from ziren_tpu_torch.stark.serialize import serialize_machine_proof
from ziren_tpu_torch.tools import (bench_prove, device_probe, engine_air, groth16_wrap,
                                   plonk_wrap, profile_device, profile_prove)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = ["--device", "cpu"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_script(rel, argv, capsys):
    """`python <rel> <argv...>` from the repository's root, in this process:
    what it printed. sys.argv and sys.path are restored after it."""
    saved_argv, saved_path = sys.argv[:], sys.path[:]
    sys.argv = [rel, *argv]
    try:
        runpy.run_path(os.path.join(REPO, rel), run_name="__main__")
    finally:
        sys.argv, sys.path[:] = saved_argv, saved_path
    return capsys.readouterr().out


@contextlib.contextmanager
def caught(owner, name):
    """While open, owner.<name> (a function of a module, or a method of a
    class) is wrapped: yields the list of every value it returned."""
    real = owner.__dict__[name]
    got = []

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        got.append(out)
        return out

    setattr(owner, name, wrapper)
    try:
        yield got
    finally:
        setattr(owner, name, real)


@pytest.fixture(scope="module")
def elf(tmp_path_factory):
    path = tmp_path_factory.mktemp("guest") / "fib.elf"
    path.write_bytes(minimal_elf(10))
    return str(path)


@pytest.mark.parametrize("rows", [16, 32])
def test_engine_air_trace(rows):
    got = engine_air.FibonacciAir().generate_trace(engine_air.Record(n=rows), None)
    want = JFibonacciAir().generate_trace(JRecord(n=rows), None)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert engine_air.fib_pv(rows) == jfib_pv(rows)


def test_engine_air_proof():
    """The two shards groth16_wrap proves, byte-equal to the JAX engine's."""
    rows = (16, 32)
    machine = StarkMachine(dev_config(), [engine_air.FibonacciAir()], num_public_values=3)
    pk, vk = machine.setup()
    proof = machine.prove(pk, [engine_air.Record(n=n, pv=engine_air.fib_pv(n)) for n in rows],
                          device="cpu")
    assert machine.verify(vk, proof)
    jmachine = JStarkMachine(jdev_config(), [JFibonacciAir()], num_public_values=3)
    jpk, _jvk = jmachine.setup()
    jproof = jmachine.prove(jpk, [JRecord(n=n, pv=jfib_pv(n)) for n in rows])
    assert serialize_machine_proof(proof) == jserialize(jproof)


def test_bench_prove(capsys):
    with caught(jmips, "prove_program") as jproofs:
        jout = run_script("tools/bench_prove.py", ["200", "dev"], capsys)
    proof = bench_prove.cli(["200", "dev", *CPU])
    tout = capsys.readouterr().out
    want, got = json.loads(jout.strip()), json.loads(tout.strip())
    for key in ("metric", "unit", "cycles", "shards", "proof_bytes", "config"):
        assert got[key] == want[key], key
    assert got["cycles"] == 1210 and got["shards"] == 1
    assert serialize_machine_proof(proof) == jserialize(jproofs[0][3])


def test_bench_prove_elf(elf, capsys):
    """n=0 proves the ELF that --elf names (here with the host prover)."""
    bench_prove.cli(["0", "dev", "--elf", elf, "--device", "host"])
    got = json.loads(capsys.readouterr().out.strip())
    assert got["cycles"] == 70 and got["shards"] == 1 and got["config"] == "dev"
    with pytest.raises(ValueError, match="--elf"):
        bench_prove.cli(["0", "dev", *CPU])


def test_prove_guest(elf, capsys):
    with caught(jsdk.ProverClient, "prove") as jproofs:
        jout = run_script("examples/prove_guest.py", [elf], capsys)
    proof = prove_guest.cli([elf, *CPU])
    tout = capsys.readouterr().out
    jlines, tlines = jout.splitlines(), tout.splitlines()
    assert tlines[0] == jlines[0] == "executed: 70 cycles, exit 0"
    assert tlines[1].split(" (", 1)[1] == jlines[1].split(" (", 1)[1] == "1 shard(s))"
    assert tlines[2:] == jlines[2:] == ["verified"]
    assert serialize_machine_proof(proof.proof) == jserialize(jproofs[0].proof)


def test_prove_guest_needs_a_path(capsys):
    with pytest.raises(SystemExit) as e:
        prove_guest.cli([])
    assert e.value.code != 0
    assert "usage:" in capsys.readouterr().err


def _drivers(elf, tmp):
    return {
        "bench_prove": (bench_prove.cli, []),
        "profile_prove": (profile_prove.cli, []),
        "profile_device": (profile_device.cli, []),
        "device_probe": (device_probe.cli, []),
        "precompiles": (precompiles.cli, []),
        "network_prover": (network_prover.cli, []),
        "prove_guest": (prove_guest.cli, [elf]),
        "groth16_wrap": (groth16_wrap.cli, ["--out", os.path.join(tmp, "g.pkl")]),
        "plonk_wrap": (plonk_wrap.cli, []),
    }


@pytest.mark.parametrize("name", ["bench_prove", "profile_prove", "profile_device",
                                  "device_probe", "precompiles", "network_prover",
                                  "prove_guest", "groth16_wrap", "plonk_wrap"])
def test_no_device_needs_cuda(name, elf, tmp_path, monkeypatch):
    """Without --device a driver proves on the GPU: with no card it raises
    before any work, and falls back to nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, argv = _drivers(elf, str(tmp_path))[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(argv)
    assert not os.path.exists(tmp_path / "g.pkl")


@pytest.mark.parametrize("driver", [profile_device, device_probe])
def test_legs_need_the_torch_prover(driver):
    with pytest.raises(ValueError, match="torch prover"):
        driver.cli(["--device", "host"])


@pytest.mark.slow
def test_groth16_wrap(tmp_path, capsys):
    """The whole driver on the CPU (tens of minutes): the artifact it
    writes verifies."""
    out = tmp_path / "artifact.pkl"
    groth16_wrap.cli(["--out", str(out), *CPU])
    stages = [line.split("] ", 1)[1] for line in capsys.readouterr().out.splitlines()]
    assert stages[:4] == ["engine proof", "compress", "shrink", "wrap (BN254 outer)"]
    assert stages[4].startswith("groth16 prove (") and stages[5] == "groth16 verify OK"
    with open(out, "rb") as f:
        assert ProverClient.groth16_verify(pickle.load(f))


@pytest.mark.slow
def test_plonk_wrap(capsys):
    """The whole driver on the CPU (tens of minutes): its artifact
    verifies."""
    artifact = plonk_wrap.cli(["20", *CPU])
    stages = [line.split("] ", 1)[1] for line in capsys.readouterr().out.splitlines()]
    assert stages[:3] == ["compressed", "shrunk", "wrapped"]
    assert stages[3].startswith("plonk proved: ") and stages[4] == "plonk verified"
    assert ProverClient.plonk_verify(artifact)
