"""The port's shard prover (ziren_tpu_torch.stark) == the host prover, bit
for bit, on the CPU; its proofs verify, a flipped byte is rejected, and the
multi-shard entry point proves a continuation that verify_mips_proof takes."""

import os

import numpy as np
import pytest
import torch

from test_jprover import assert_proofs_equal
from test_stark_engine import FibonacciAir, Record, fib_pv

from ziren_tpu.stark.config import dev_config
from ziren_tpu.stark.machine import StarkMachine
from ziren_tpu.stark.proof import MachineProof
from ziren_tpu.stark.prover import prove_shard
from ziren_tpu.stark.serialize import deserialize_shard_proof, serialize_shard_proof
from ziren_tpu.stark.verifier import VerificationError
from ziren_tpu_torch.stark import tprover
from ziren_tpu_torch.stark.machine import prove

# Under pytest-xdist each worker keeps to one torch thread: the workers
# already fill the cores, and torch's thread pool on top of them slows
# every worker down.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _both(machine, pk, record):
    base = machine.config.challenger()
    pk.vk.observe_into(base)
    host = prove_shard(machine, pk, record, base.clone())
    port = tprover.prove_shard(machine, pk, record, base.clone(), "cpu")
    return host, port


def test_fibonacci_air_matches_host():
    machine = StarkMachine(dev_config(), [FibonacciAir()], num_public_values=3)
    pk, vk = machine.setup()
    host, port = _both(machine, pk, Record(n=32, pv=fib_pv(32)))
    assert_proofs_equal(host, port)
    assert serialize_shard_proof(port) == serialize_shard_proof(host)
    assert machine.verify(vk, MachineProof([port]))


@pytest.fixture(scope="module")
def mips30():
    from ziren_tpu.executor.asm import fibonacci_program
    from ziren_tpu.machine.mips import execute, mips_machine

    program = fibonacci_program(30)
    machine = mips_machine(dev_config())
    pk, vk = machine.setup(program)
    _ex, record = execute(program)
    host, port = _both(machine, pk, record)
    return machine, vk, program, host, port, pk


def test_mips_shard_matches_host(mips30):
    """Full MIPS shard: preprocessed traces, the Global chip's septic sums,
    every chip through the torch folders."""
    from ziren_tpu.machine.mips import verify_mips_proof

    machine, vk, program, host, port, _pk = mips30
    assert_proofs_equal(host, port)
    assert serialize_shard_proof(port) == serialize_shard_proof(host)
    assert verify_mips_proof(machine, vk, MachineProof([port]), pc_start=program.pc_start)


@pytest.mark.parametrize("where", [0.001, 0.3, 0.7])
def test_flipped_byte_is_rejected(mips30, where):
    machine, vk, _program, _host, port, _pk = mips30
    data = bytearray(serialize_shard_proof(port))
    data[int(len(data) * where)] ^= 0x01
    tampered = deserialize_shard_proof(bytes(data))
    with pytest.raises(VerificationError):
        machine.verify(vk, MachineProof([tampered]))


def test_device_pk_checks_the_host_commit(mips30):
    """The preprocessed commit re-derived on the device must equal pk.commit."""
    import dataclasses

    machine, *_rest, pk = mips30
    bad = dataclasses.replace(pk, commit=(np.asarray(pk.commit) + 1) % 2130706433)
    with pytest.raises(RuntimeError, match="preprocessed commit"):
        tprover.device_pk(machine, bad, "cpu")


def test_multishard_prove_verifies():
    """Two shards of fibonacci(600) at shard size 2048 through the port's
    entry point with fixed shapes; the continuation verifies."""
    from ziren_tpu.executor.asm import fibonacci_program
    from ziren_tpu.machine.mips import execute_sharded, mips_machine, verify_mips_proof

    program = fibonacci_program(600)
    machine = mips_machine(dev_config())
    pk, vk = machine.setup(program)
    _ex, records = execute_sharded(program, 2048)
    assert len(records) == 2
    stats = {}
    proof = prove(machine, pk, records, device="cpu", fix_shapes=True, stats=stats)
    assert len(proof.shard_proofs) == 2 and len(stats["dispatch_s"]) == 2
    assert verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)
    heights = [[ov.log_degree for ov in sp.opened_values] for sp in proof.shard_proofs]
    names = [sp.chip_names for sp in proof.shard_proofs]
    common = set(names[0]) & set(names[1])
    for n in common:  # one batch-wide shape
        assert heights[0][names[0].index(n)] == heights[1][names[1].index(n)]
