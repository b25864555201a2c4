"""Unconstrained blocks and the hint stream through the port, on the CPU,
against the JAX package (tests/test_unconstrained.py holds the JAX package
alone).

ENTER_UNCONSTRAINED runs a block untraced; EXIT_UNCONSTRAINED reverts every
state but the hint stream and replays the ENTER returning 0; HINT_LEN and
HINT_READ then read what the block wrote. The program is
test_unconstrained.py's, as ziren_tpu_torch/tools/memory_programs.py builds
it from either package's asm (each build is held word for word against that
file's). The port's
executor keeps the hint and reverts the block, and its proof with
device="cpu" is byte-equal to its host prover's and to the JAX package's;
each package's verifier takes the other's bytes."""

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
import ziren_tpu_torch.stark.serialize as tser
from test_unconstrained import _program as jax_program
from ziren_tpu.executor import Executor as JExecutor
from ziren_tpu_torch.executor import Executor
from ziren_tpu_torch.machine.debug import debug_constraints, debug_lookups
from ziren_tpu_torch.stark import carry
from ziren_tpu_torch.tools.memory_programs import unconstrained_program

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _words(program) -> list:
    return [(i.opcode.value, i.op_a, i.op_b, i.op_c, i.imm_b, i.imm_c)
            for i in program.instructions] + [program.pc_start]


def test_the_program_is_test_unconstrained_s():
    assert (_words(unconstrained_program(jasm)) == _words(jax_program())
            == _words(unconstrained_program(tasm)))


def test_hint_roundtrip_and_revert():
    ex = Executor(unconstrained_program(tasm))
    rec = ex.run()
    assert ex.peek_register(20) == 42  # the hint made in the block, read back
    assert ex.peek_register(21) == 4
    assert ex.peek_word(0x2000) == 0  # the block's writes reverted
    sids = [int(s) for s in rec.freeze()["syscall_code"] if s]
    assert 4 not in sids  # no EXIT in the trace
    assert sids.count(3) == 1  # the replayed ENTER alone


@pytest.fixture(scope="module")
def proofs():
    """The program's one shard at the dev config, its vk observing the entry
    pc: the JAX package's host proof and the port's with device="cpu" and
    "host"."""
    jprog = unconstrained_program(jasm)
    jm = jmips.mips_machine(jconfig.dev_config())
    jpk, jvk = jm.setup(jprog, extra_observations=[jprog.pc_start])
    jbytes = [jser.serialize_shard_proof(sp)
              for sp in jm.prove(jpk, [JExecutor(jprog).run()]).shard_proofs]
    prog = unconstrained_program(tasm)
    machine = tmips.mips_machine(tconfig.dev_config())
    pk, vk = machine.setup(prog, extra_observations=[prog.pc_start])
    rec = Executor(prog).run()
    imbalance, origin = debug_lookups(machine, pk, rec)
    assert not imbalance, origin
    assert debug_constraints(machine, pk, rec)
    out = {d: [tser.serialize_shard_proof(sp)
               for sp in machine.prove(pk, [Executor(prog).run()], device=d).shard_proofs]
           for d in ("cpu", "host")}
    return {"jax": jbytes, "jax_side": (jprog, jm, jvk), "port_side": (prog, machine, vk),
            **out}


def test_unconstrained_proof_matches_host_and_jax(proofs):
    assert len(proofs["cpu"]) == 1
    assert proofs["cpu"] == proofs["host"] == proofs["jax"]


def test_unconstrained_proofs_verify_across(proofs):
    prog, machine, vk = proofs["port_side"]
    jprog, jm, jvk = proofs["jax_side"]
    assert tmips.verify_mips_proof(machine, vk,
                                   carry.machine_proof_from_shard_bytes(proofs["jax"]),
                                   pc_start=prog.pc_start)
    assert jmips.verify_mips_proof(
        jm, jvk, jproof.MachineProof([jser.deserialize_shard_proof(b) for b in proofs["cpu"]]),
        pc_start=jprog.pc_start)
