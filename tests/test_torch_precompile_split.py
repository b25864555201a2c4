"""A deferred precompile shard through the port's multi-shard entry point,
on the CPU. A program of Poseidon2 permutes
(ziren_tpu_torch.tools.precompile_programs.multi_poseidon2_program), split
with a deferral threshold of two rows, makes precompile shards that hold no
Cpu (executor/split.py:finalize_precompiles); stark.machine.prove with fixed
shapes proves them, shard for shard, as the JAX package's
StarkMachine.prove does, and each package's verifier takes the other's
bytes."""

import os

import pytest
import torch

import ziren_tpu.executor.asm as jasm
import ziren_tpu.machine.mips as jmips
import ziren_tpu.stark.config as jconfig
import ziren_tpu.stark.proof as jproof
import ziren_tpu.stark.serialize as jser
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.machine as tmachine
import ziren_tpu_torch.stark.serialize as tser
from ziren_tpu_torch.tools import precompile_programs as pp

# Under pytest-xdist each worker keeps to one torch thread: the workers
# already fill the cores, and torch's thread pool on top of them slows
# every worker down.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def deferred():
    """multi_poseidon2_program(3) in shards of 4,096 cycles with a deferral
    threshold of two rows: the execution shard and two Poseidon2Permute
    shards without Cpu. The JAX package's host proof and the port's proof
    through stark.machine.prove on the CPU, both with fixed shapes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZIREN_SPLIT_DEFERRED", "2")
        jprog = pp.multi_poseidon2_program(jasm, 3)
        jm = jmips.mips_machine(jconfig.dev_config())
        jpk, jvk = jm.setup(jprog)
        _ex, jrecs = jmips.execute_sharded(jprog, 4096)
        jbytes = [jser.serialize_shard_proof(sp)
                  for sp in jm.prove(jpk, jrecs, fix_shapes=True).shard_proofs]

        prog = pp.multi_poseidon2_program(tasm, 3)
        machine = tmips.mips_machine(tconfig.dev_config())
        pk, vk = machine.setup(prog)
        _ex, recs = tmips.execute_sharded(prog, 4096)
        proof = tmachine.prove(machine, pk, recs, device="cpu", fix_shapes=True)
    return {"jax": jbytes, "jax_machine": jm, "jax_vk": jvk, "jax_program": jprog,
            "machine": machine, "vk": vk, "program": prog, "proof": proof}


def test_deferred_shards_match_jax(deferred):
    got = [tser.serialize_shard_proof(sp) for sp in deferred["proof"].shard_proofs]
    assert len(got) == len(deferred["jax"]) == 3
    assert got == deferred["jax"]


def test_deferred_shards_hold_no_cpu(deferred):
    names = [set(sp.chip_names) for sp in deferred["proof"].shard_proofs]
    standalone = [n for n in names if "SyscallPrecompile" in n and "Cpu" not in n]
    assert len(standalone) == 2 and all("Poseidon2Permute" in n for n in standalone)
    assert any("SyscallCore" in n and "Cpu" in n for n in names)


def test_deferred_proofs_verify_across(deferred):
    assert tmips.verify_mips_proof(deferred["machine"], deferred["vk"], deferred["proof"],
                                   pc_start=deferred["program"].pc_start)
    jmp = jproof.MachineProof([jser.deserialize_shard_proof(b) for b in
                               (tser.serialize_shard_proof(sp)
                                for sp in deferred["proof"].shard_proofs)])
    assert jmips.verify_mips_proof(deferred["jax_machine"], deferred["jax_vk"], jmp,
                                   pc_start=deferred["jax_program"].pc_start)
