"""machine.mips.prove_program_checkpointed in the port proves on the torch
device (the GPU by default): on the CPU its proof is byte-equal, shard for
shard, to the port's host prover's and to the JAX package's, at the
smallest fibonacci that makes two shards, and its shards carry the main
commitments and public values of prove_program's (as
tests/test_checkpoint.py holds the JAX package's); a prefix of the
execution (`shards=1`) is the first shard of the whole proof, byte for
byte."""

import os

import numpy as np
import pytest
import torch

from ziren_tpu.executor.asm import fibonacci_program as jfibonacci_program
from ziren_tpu.machine.mips import prove_program_checkpointed as jcheckpointed
from ziren_tpu.stark.config import dev_config as jdev_config
from ziren_tpu.stark.serialize import serialize_shard_proof as jserialize
from ziren_tpu_torch.executor.asm import fibonacci_program
from ziren_tpu_torch.machine.mips import (prove_program, prove_program_checkpointed,
                                          verify_mips_proof)
from ziren_tpu_torch.stark import tprover
from ziren_tpu_torch.stark.config import dev_config
from ziren_tpu_torch.stark.serialize import serialize_shard_proof

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

N, SHARD_SIZE = 200, 1024


def test_checkpointed_cpu_equals_host_and_jax(monkeypatch):
    program = fibonacci_program(N)
    torch_proved = []  # the device of each shard the torch prover proved
    real = tprover.prove_shard

    def counted(machine, pk, record, challenger, device):
        torch_proved.append(device)
        return real(machine, pk, record, challenger, device)

    monkeypatch.setattr(tprover, "prove_shard", counted)
    machine, _pk, vk, proof, scout = prove_program_checkpointed(
        program, config=dev_config(), shard_size=SHARD_SIZE, device="cpu")
    assert len(proof.shard_proofs) == 2 and scout.exit_code == 0
    assert torch_proved == [torch.device("cpu")] * 2
    assert verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)
    got = [serialize_shard_proof(sp) for sp in proof.shard_proofs]
    host = prove_program_checkpointed(program, config=dev_config(), shard_size=SHARD_SIZE,
                                      device="host")[3]
    assert len(torch_proved) == 2  # "host" is the numpy prover
    assert [serialize_shard_proof(sp) for sp in host.shard_proofs] == got
    # a prefix of the execution: its first shard, the same bytes
    prefix = prove_program_checkpointed(program, config=dev_config(), shard_size=SHARD_SIZE,
                                        device="host", shards=1)[3]
    assert [serialize_shard_proof(sp) for sp in prefix.shard_proofs] == got[:1]
    jproof = jcheckpointed(jfibonacci_program(N), config=jdev_config(),
                           shard_size=SHARD_SIZE)[3]
    assert [jserialize(sp) for sp in jproof.shard_proofs] == got
    # the regular pipeline's shards (the host prover: the commitments are
    # the traces', whoever proves)
    regular = prove_program(program, config=dev_config(), shard_size=SHARD_SIZE,
                            device="host")[3]
    assert len(regular.shard_proofs) == len(proof.shard_proofs)
    for a, b in zip(proof.shard_proofs, regular.shard_proofs):
        assert np.array_equal(a.commitment.main, b.commitment.main)
        assert a.public_values == b.public_values


def test_checkpointed_default_device_needs_cuda(monkeypatch):
    """device=None is the GPU: without one it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prove_program_checkpointed(fibonacci_program(N), config=dev_config(),
                                   shard_size=SHARD_SIZE)
