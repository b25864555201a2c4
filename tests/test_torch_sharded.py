"""The port's data-parallel paths over a mesh of CPU members:
stark.machine.prove(devices=...), shards in turn over the members, under
ZIREN_FUSED=1 (one _FusedShard per member, its body run without capture on
the CPU) and eagerly (the eager shard prover).

Each proof is byte-equal to the port's host prover (device="host") and to
the JAX package's host prover on the same records, and verifies. The shards
differ from one another, so a shard proved on the wrong member, or returned
in the wrong order, shows. The CUDA side, members with streams of their own
on one card, runs in chip_smoke.py phase 12."""

import os

import numpy as np
import pytest
import torch

from test_stark_engine import FibonacciAir, Record
from test_torch_folder import PortFibonacciAir

import ziren_tpu.executor.asm as jasm
import ziren_tpu.machine.mips as jmips
import ziren_tpu.stark.config as jconfig
import ziren_tpu.stark.machine as jmachine
import ziren_tpu.stark.serialize as jser
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.machine as tmachine
import ziren_tpu_torch.stark.serialize as tser
from ziren_tpu_torch.core import field as F
from ziren_tpu_torch.device import Mesh
from ziren_tpu_torch.stark import tfused, tprover

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SHARDS = 8


def _start_trace(self, record, output):
    """A Fibonacci trace from the record's first two public values."""
    a, b = record.public_values[:2]
    rows = []
    for _ in range(record.n):
        rows.append([a, b])
        a, b = b, (a + b) % F.P_INT
    return np.asarray(rows, np.uint32)


class _Start(FibonacciAir):
    generate_trace = _start_trace


class _PortStart(PortFibonacciAir):
    generate_trace = _start_trace


def _records(n=32):
    """SHARDS shards, each its own start: (i, i + 1) to its last value."""
    out = []
    for i in range(SHARDS):
        a, b = i, i + 1
        for _ in range(n - 1):
            a, b = b, (a + b) % F.P_INT
        out.append(Record(n=n, pv=[i, i + 1, b]))
    return out


def _bytes(proof):
    return [tser.serialize_shard_proof(sp) for sp in proof.shard_proofs]


@pytest.fixture(scope="module")
def engine():
    jm = jmachine.StarkMachine(jconfig.dev_config(), [_Start()], num_public_values=3)
    jpk, _ = jm.setup()
    tm = tmachine.StarkMachine(tconfig.dev_config(), [_PortStart()], num_public_values=3)
    tpk, tvk = tm.setup()
    want = [jser.serialize_shard_proof(sp) for sp in jm.prove(jpk, _records()).shard_proofs]
    assert len(set(want)) == SHARDS
    assert _bytes(tm.prove(tpk, _records(), device="host")) == want
    return tm, tpk, tvk, want


@pytest.mark.parametrize("members", [8, 3])
def test_engine_shards_sharded(engine, members, monkeypatch):
    """The fused path (ZIREN_FUSED=1) of 8 shards over 8 members (one each)
    and over 3 (in turn): in record order, byte-equal to both host provers;
    each member built a _FusedShard of its own for the one shape, under a
    key of its own."""
    tm, tpk, tvk, want = engine
    mesh = Mesh(["cpu"] * members, axis="shard")
    stats = {}
    monkeypatch.setenv("ZIREN_FUSED", "1")
    proof = tmachine.prove(tm, tpk, _records(), devices=mesh, stats=stats)
    assert _bytes(proof) == want
    assert tm.verify(tvk, proof)
    assert stats["member"] == [i % members for i in range(SHARDS)]
    assert len(stats["built"]) == members
    chips, _t, domains, _pv = tprover.shard_layout(tm, _records()[0])
    keys = {tfused._machine_key(tm, tpk, chips, domains, torch.device("cpu"), m) for m in mesh}
    assert len(keys) == members


@pytest.mark.parametrize("members", [8, 3])
def test_engine_devices_round_robin(engine, members):
    """StarkMachine.prove(devices=...) with a list of devices, which
    becomes a mesh, and the module-level prove with a Mesh."""
    tm, tpk, tvk, want = engine
    proof = tm.prove(tpk, _records(), devices=["cpu"] * members)
    assert _bytes(proof) == want
    assert tm.verify(tvk, proof)
    stats = {}
    again = tmachine.prove(tm, tpk, _records(), devices=Mesh(["cpu"] * members, "shard"),
                           stats=stats)
    assert _bytes(again) == want and len(stats["dispatch_s"]) == SHARDS


@pytest.fixture(scope="module")
def mips600():
    """fibonacci(600) at the dev config in 2 shards of 2048 cycles: the JAX
    package's host proof and the port's, padded to one shape."""
    jprog = jasm.fibonacci_program(600)
    jm = jmips.mips_machine(jconfig.dev_config())
    jpk, _ = jm.setup(jprog)
    _ex, jrecords = jmips.execute_sharded(jprog, 2048)
    want = [jser.serialize_shard_proof(sp)
            for sp in jm.prove(jpk, jrecords, fix_shapes=True).shard_proofs]
    program = tasm.fibonacci_program(600)
    machine = tmips.mips_machine(tconfig.dev_config())
    pk, vk = machine.setup(program)
    _ex, records = tmips.execute_sharded(program, 2048)
    assert len(records) == 2
    assert _bytes(machine.prove(pk, records, device="host", fix_shapes=True)) == want
    return program, machine, pk, vk, want


def test_mips_shards_sharded(mips600, monkeypatch):
    """The fused path over 2 members pads the shards to one shape by
    itself: StarkMachine.prove's fix_shapes is left False."""
    program, machine, pk, vk, want = mips600
    _ex, records = tmips.execute_sharded(program, 2048)
    monkeypatch.setenv("ZIREN_FUSED", "1")
    proof = machine.prove(pk, records, devices=Mesh(["cpu", "cpu"], "shard"))
    assert _bytes(proof) == want
    assert tmips.verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)


def test_mips_devices_round_robin(mips600):
    program, machine, pk, vk, want = mips600
    _ex, records = tmips.execute_sharded(program, 2048)
    proof = machine.prove(pk, records, fix_shapes=True, devices=Mesh(["cpu", "cpu"], "shard"))
    assert _bytes(proof) == want
    assert tmips.verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)


def test_device_and_devices_together_raise(engine):
    tm, tpk, _tvk, _want = engine
    for device in ("cpu", "host"):
        with pytest.raises(ValueError, match="not both"):
            tm.prove(tpk, _records(), device=device, devices=["cpu"])
    with pytest.raises(ValueError, match="not both"):
        tmachine.prove(tm, tpk, _records(), device="cpu", devices=["cpu"])


def test_no_mesh_without_cuda(engine, monkeypatch):
    """The default mesh is one member per card: without CUDA it raises, and
    so does every path that would take it, with no CPU member in its place."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    tm, tpk, _tvk, _want = engine
    for make in (Mesh.default, lambda: Mesh(["cuda"]), lambda: Mesh([None, None])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    monkeypatch.setenv("ZIREN_FUSED", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmachine.prove(tm, tpk, _records(), devices=[None, None])
    with pytest.raises(ValueError, match="all CUDA or all CPU|at least one"):
        Mesh([])
