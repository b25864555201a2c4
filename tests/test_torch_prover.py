"""The port's shard prover (ziren_tpu_torch.stark) == the host prover, bit
for bit, on the CPU, across the package border: the JAX package and the port
each build their own machine, keys, records and host proof from the same
program, and the proofs are compared as bytes and by each package's
verifier taking the other's bytes. The port's proofs verify, a flipped byte
is rejected, and the multi-shard entry point proves a continuation that
verify_mips_proof takes."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_stark_engine import FibonacciAir, Record, fib_pv
from test_torch_folder import PortFibonacciAir

import ziren_tpu.executor.asm as jasm
import ziren_tpu.machine.mips as jmips
import ziren_tpu.stark.config as jconfig
import ziren_tpu.stark.machine as jmachine
import ziren_tpu.stark.proof as jproof
import ziren_tpu.stark.prover as jprover_host
import ziren_tpu.stark.serialize as jser
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.machine as tmachine
import ziren_tpu_torch.stark.proof as tproof
import ziren_tpu_torch.stark.prover as tprover_host
import ziren_tpu_torch.stark.serialize as tser
import ziren_tpu_torch.stark.verifier as tverifier
from ziren_tpu_torch.stark import carry, tprover

# Under pytest-xdist each worker keeps to one torch thread: the workers
# already fill the cores, and torch's thread pool on top of them slows
# every worker down.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _base(machine, pk):
    base = machine.config.challenger()
    pk.vk.observe_into(base)
    return base


def test_fibonacci_air_matches_host():
    jm = jmachine.StarkMachine(jconfig.dev_config(), [FibonacciAir()], num_public_values=3)
    jpk, jvk = jm.setup()
    jhost = jprover_host.prove_shard(jm, jpk, Record(n=32, pv=fib_pv(32)), _base(jm, jpk))

    tm = tmachine.StarkMachine(tconfig.dev_config(), [PortFibonacciAir()], num_public_values=3)
    tpk, tvk = tm.setup()
    record = Record(n=32, pv=fib_pv(32))
    thost = tprover_host.prove_shard(tm, tpk, record, _base(tm, tpk))
    port = tprover.prove_shard(tm, tpk, record, _base(tm, tpk), "cpu")

    data = tser.serialize_shard_proof(port)
    assert data == tser.serialize_shard_proof(thost) == jser.serialize_shard_proof(jhost)
    assert tm.verify(tvk, tproof.MachineProof([port]))
    # StarkMachine.prove reaches the same torch prover
    via_method = tm.prove(tpk, [record], device="cpu")
    assert [tser.serialize_shard_proof(sp) for sp in via_method.shard_proofs] == [data]
    assert jm.verify(jvk, jproof.MachineProof([jser.deserialize_shard_proof(data)]))


@dataclasses.dataclass
class Side:
    machine: object
    pk: object
    vk: object
    program: object
    host_bytes: bytes


@pytest.fixture(scope="module")
def mips30():
    """fibonacci(30) at the dev config: the JAX package's side, the port's
    side, and the port's torch proof of its own record."""
    jprog = jasm.fibonacci_program(30)
    jm = jmips.mips_machine(jconfig.dev_config())
    jpk, jvk = jm.setup(jprog)
    _ex, jrec = jmips.execute(jprog)
    jhost = jprover_host.prove_shard(jm, jpk, jrec, _base(jm, jpk))
    jax_side = Side(jm, jpk, jvk, jprog, jser.serialize_shard_proof(jhost))

    tprog = tasm.fibonacci_program(30)
    tm = tmips.mips_machine(tconfig.dev_config())
    tpk, tvk = tm.setup(tprog)
    _ex, trec = tmips.execute(tprog)
    thost = tprover_host.prove_shard(tm, tpk, trec, _base(tm, tpk))
    port_side = Side(tm, tpk, tvk, tprog, tser.serialize_shard_proof(thost))
    port = tprover.prove_shard(tm, tpk, trec, _base(tm, tpk), "cpu")
    return jax_side, port_side, port


def test_mips_shard_matches_host(mips30):
    """Full MIPS shard: preprocessed traces, the Global chip's septic sums,
    every chip through the torch folders. One proof, byte for byte, from
    the port's torch prover, the port's host prover and the JAX package's
    host prover; each package's verifier takes the other's bytes."""
    jax_side, port_side, port = mips30
    data = tser.serialize_shard_proof(port)
    assert data == port_side.host_bytes
    assert data == jax_side.host_bytes
    assert tmips.verify_mips_proof(
        port_side.machine, port_side.vk,
        carry.machine_proof_from_shard_bytes([jax_side.host_bytes]),
        pc_start=port_side.program.pc_start)
    assert jmips.verify_mips_proof(
        jax_side.machine, jax_side.vk,
        jproof.MachineProof([jser.deserialize_shard_proof(data)]),
        pc_start=jax_side.program.pc_start)


def test_proving_key_carries_across(mips30):
    """The JAX package's proving key, taken apart into numpy arrays by hand,
    is rebuilt by the port with the same commitment as the port's own setup;
    a wrong commitment is refused."""
    jax_side, port_side, _port = mips30
    jpk = jax_side.pk
    order = sorted(jpk.chip_ordering, key=jpk.chip_ordering.get)
    traces = {n: np.array(jpk.preprocessed_by_name[n], np.uint32) for n in order}
    commit = np.array(jpk.commit, np.uint32)
    pk, vk = carry.proving_key_from_arrays(
        port_side.machine, commit, traces, jpk.vk.extra_observations)
    assert np.array_equal(pk.commit, commit) and np.array_equal(vk.commit, commit)
    assert np.array_equal(port_side.pk.commit, commit)
    assert pk.chip_ordering == port_side.pk.chip_ordering
    own = carry.proving_key_arrays(port_side.pk)
    assert list(own["traces"]) == order
    for n in order:
        assert np.array_equal(own["traces"][n], traces[n]), n
    # the device prover's re-derived preprocessed commit agrees too
    tprover.device_pk(port_side.machine, pk, "cpu")
    with pytest.raises(ValueError, match="commitment differs"):
        carry.proving_key_from_arrays(port_side.machine, (commit + 1) % 2130706433, traces)


@pytest.mark.parametrize("where", [0.001, 0.3, 0.7])
def test_flipped_byte_is_rejected(mips30, where):
    _jax_side, port_side, port = mips30
    data = bytearray(tser.serialize_shard_proof(port))
    data[int(len(data) * where)] ^= 0x01
    tampered = carry.shard_proof_from_bytes(bytes(data))
    with pytest.raises(tverifier.VerificationError):
        port_side.machine.verify(port_side.vk, tproof.MachineProof([tampered]))


def test_device_pk_checks_the_host_commit(mips30):
    """The preprocessed commit re-derived on the device must equal pk.commit."""
    _jax_side, port_side, _port = mips30
    pk = port_side.pk
    bad = dataclasses.replace(pk, commit=(np.asarray(pk.commit) + 1) % 2130706433)
    with pytest.raises(RuntimeError, match="preprocessed commit"):
        tprover.device_pk(port_side.machine, bad, "cpu")


def test_prove_without_a_device_needs_the_gpu(mips30):
    """`device` defaults to the GPU: without one the entry points raise and
    never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    _jax_side, port_side, _port = mips30
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmachine.prove(port_side.machine, port_side.pk, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_side.machine.prove(port_side.pk, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmips.prove_program(port_side.program, config=tconfig.dev_config())


def test_multishard_prove_verifies():
    """Two shards of fibonacci(600) at shard size 2048 through the port's
    entry point with fixed shapes; the continuation verifies in both
    packages, and the host prover behind StarkMachine.prove gives the same bytes."""
    program = tasm.fibonacci_program(600)
    machine = tmips.mips_machine(tconfig.dev_config())
    pk, vk = machine.setup(program)
    _ex, records = tmips.execute_sharded(program, 2048)
    assert len(records) == 2
    stats = {}
    proof = tmachine.prove(machine, pk, records, device="cpu", fix_shapes=True, stats=stats)
    assert len(proof.shard_proofs) == 2 and len(stats["dispatch_s"]) == 2
    assert tmips.verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)
    heights = [[ov.log_degree for ov in sp.opened_values] for sp in proof.shard_proofs]
    names = [sp.chip_names for sp in proof.shard_proofs]
    common = set(names[0]) & set(names[1])
    for n in common:  # one batch-wide shape
        assert heights[0][names[0].index(n)] == heights[1][names[1].index(n)]

    shard_bytes = [tser.serialize_shard_proof(sp) for sp in proof.shard_proofs]
    on_host = machine.prove(pk, records, device="host", fix_shapes=True)
    assert [tser.serialize_shard_proof(sp) for sp in on_host.shard_proofs] == shard_bytes

    jprog = jasm.fibonacci_program(600)
    jm = jmips.mips_machine(jconfig.dev_config())
    _jpk, jvk = jm.setup(jprog)
    jmp = jproof.MachineProof([jser.deserialize_shard_proof(b) for b in shard_bytes])
    assert jmips.verify_mips_proof(jm, jvk, jmp, pc_start=jprog.pc_start)
