"""Standalone memory shards through the port, on the CPU, against the JAX
package (tests/test_memory_split.py holds the JAX package alone).

Once the addresses an execution touches pass combine_memory_threshold,
executor/split.py:finalize_memory moves the MemoryInit/MemoryFinal events
into shards with no Cpu, chained by the address bits of their public
values. The records here are test_memory_split.py's: fibonacci(30) in shards
of 40 cycles, re-split with three events a memory shard and a threshold of
four. The port's proof of them with device="cpu" (the kernels' plain
versions) is byte-equal to its host prover's and to the JAX package's, each
package's verifier takes the other's bytes and refuses a tampered chain, and
the port's debug oracles hold the forged-bits and zero-anchor cases as the
JAX package's do. Last, tools/memory_programs.py's sweep, built from each
package's asm, executes to the same records in both."""

import copy
import os

import pytest
import torch

import ziren_tpu.executor.asm as jasm
import ziren_tpu.machine.mips as jmips
import ziren_tpu.stark.config as jconfig
import ziren_tpu.stark.proof as jproof
import ziren_tpu.stark.serialize as jser
import ziren_tpu.stark.verifier as jverifier
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.serialize as tser
import ziren_tpu_torch.stark.verifier as tverifier
from test_memory_split import _split_records as jax_split_records
from ziren_tpu_torch.core import septic as S
from ziren_tpu_torch.executor import Executor
from ziren_tpu_torch.executor.split import SplitOpts, addr_bits, finalize_memory
from ziren_tpu_torch.machine.debug import debug_constraints, debug_lookups
from ziren_tpu_torch.machine.global_chip import GlobalChip
from ziren_tpu_torch.stark import carry
from ziren_tpu_torch.tools import memory_programs as mpg

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SPLIT_ENV = {"ZIREN_SPLIT_MEMORY": "3", "ZIREN_COMBINE_MEMORY_THRESHOLD": "4"}


def split_records(n=30, shard_size=40, memory=3):
    """test_memory_split.py's _split_records, through the port."""
    records = Executor(tasm.fibonacci_program(n), shard_size=shard_size).run_sharded()
    return finalize_memory(records, SplitOpts(memory=memory, combine_memory_threshold=4))


def _packed(bits):
    return sum(int(b) << i for i, b in enumerate(bits))


def assert_same_records(ours, theirs):
    """The port's records and the JAX package's: cycles, public values and
    memory events, record for record."""
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.num_cycles == b.num_cycles
        assert ([int(v) for v in a.public_values.to_list()]
                == [int(v) for v in b.public_values.to_list()])
        assert [tuple(e) for e in a.mem_init] == [tuple(e) for e in b.mem_init]
        assert [tuple(e) for e in a.mem_final] == [tuple(e) for e in b.mem_final]


def test_split_structure_and_chain():
    records = split_records()
    mem = [r for r in records if r.num_cycles == 0]
    ex = [r for r in records if r.num_cycles > 0]
    assert len(mem) >= 2, "expected multiple standalone memory shards"
    for r in ex:
        assert not r.mem_init and not r.mem_final
        assert _packed(r.public_values.previous_init_addr_bits) == 0
        assert _packed(r.public_values.last_init_addr_bits) == 0
    assert mem[0].mem_init[0][0] == 0
    prev_i = prev_f = 0
    for r in mem:
        pv = r.public_values
        assert _packed(pv.previous_init_addr_bits) == prev_i
        assert _packed(pv.previous_finalize_addr_bits) == prev_f
        addrs_i = [a for a, _ in r.mem_init]
        addrs_f = [a for a, *_ in r.mem_final]
        assert all(x < y for x, y in zip(addrs_i, addrs_i[1:]))
        if addrs_i:
            assert addrs_i[0] > prev_i or (prev_i == 0 and addrs_i[0] == 0)
            prev_i = addrs_i[-1]
        if addrs_f:
            prev_f = addrs_f[-1]
        assert _packed(pv.last_init_addr_bits) == prev_i
        assert _packed(pv.last_finalize_addr_bits) == prev_f
        assert pv.start_pc == pv.next_pc
    for i, r in enumerate(records):
        assert r.public_values.shard == i + 1
    # and the JAX package's split of the same execution, record for record
    assert_same_records(records, jax_split_records())


def test_split_debug_oracles():
    records = split_records()
    machine = tmips.mips_machine()
    pk, _vk = machine.setup(tasm.fibonacci_program(30))
    digests = []
    for rec in records:
        imbalance, _ = debug_lookups(machine, pk, rec)
        assert not imbalance
        debug_constraints(machine, pk, rec)
        tr = GlobalChip().generate_trace(rec, rec)
        digests.append((tr[-1, -14:-7], tr[-1, -7:]))
    assert S.digests_balance(digests)


def test_forged_last_bits_violate_air():
    rec = [r for r in split_records() if r.num_cycles == 0][0]
    machine = tmips.mips_machine()
    pk, _vk = machine.setup(tasm.fibonacci_program(30))
    true_last = _packed(rec.public_values.last_init_addr_bits)
    rec.public_values.last_init_addr_bits = addr_bits(true_last + 4)
    with pytest.raises(AssertionError):
        debug_constraints(machine, pk, rec)


def test_bootstrap_zero_anchor():
    rec = [r for r in split_records() if r.num_cycles == 0][0]
    rec.mem_init = rec.mem_init[1:]
    rec.mem_final = rec.mem_final[1:]
    machine = tmips.mips_machine()
    pk, _vk = machine.setup(tasm.fibonacci_program(30))
    with pytest.raises(AssertionError):
        debug_constraints(machine, pk, rec)


@pytest.fixture(scope="module")
def split_proofs():
    """prove_program of fibonacci(30) in shards of 40 at the dev config under
    ZIREN_SPLIT_MEMORY=3 and ZIREN_COMBINE_MEMORY_THRESHOLD=4: the JAX
    package's, and the port's with device="cpu" and "host"."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SPLIT_ENV.items():
            mp.setenv(k, v)
        jprog = jasm.fibonacci_program(30)
        jm, _jpk, jvk, jpf, _ex = jmips.prove_program(jprog, shard_size=40,
                                                      config=jconfig.dev_config())
        prog = tasm.fibonacci_program(30)
        out = {}
        for device in ("cpu", "host"):
            m, _pk, vk, pf, _ex = tmips.prove_program(prog, shard_size=40,
                                                      config=tconfig.dev_config(),
                                                      device=device)
            out[device] = [tser.serialize_shard_proof(sp) for sp in pf.shard_proofs]
    return {"jax": [jser.serialize_shard_proof(sp) for sp in jpf.shard_proofs],
            "jax_side": (jprog, jm, jvk), "port_side": (prog, m, vk), **out}


def test_split_proof_matches_host_and_jax(split_proofs):
    got = split_proofs["cpu"]
    assert got == split_proofs["host"] == split_proofs["jax"]
    names = [set(sp.chip_names) for sp in
             carry.machine_proof_from_shard_bytes(got).shard_proofs]
    standalone = [n for n in names if "Cpu" not in n]
    assert len(standalone) >= 2 and any("Cpu" in n for n in names)
    assert all({"MemoryInit", "MemoryFinal", "Global"} <= n for n in standalone)


def _tampered(proof):
    """The proof with the first set bit of a memory shard's chain cleared
    (test_memory_split.py:92-101)."""
    for sp in proof.shard_proofs:
        if "Cpu" not in sp.chip_names:
            k = sp.public_values.index(1, 45)
            sp.public_values[k] = 0
            return proof
    raise AssertionError("no memory shard")


def test_split_proofs_verify_across_and_refuse_a_tampered_chain(split_proofs):
    prog, m, vk = split_proofs["port_side"]
    jprog, jm, jvk = split_proofs["jax_side"]

    def theirs():
        return jproof.MachineProof([jser.deserialize_shard_proof(b)
                                    for b in split_proofs["cpu"]])

    def ours():
        return carry.machine_proof_from_shard_bytes(split_proofs["jax"])

    assert tmips.verify_mips_proof(m, vk, ours(), pc_start=prog.pc_start)
    assert jmips.verify_mips_proof(jm, jvk, theirs(), pc_start=jprog.pc_start)
    with pytest.raises(tverifier.VerificationError):
        tmips.verify_mips_proof(m, vk, _tampered(ours()))
    with pytest.raises(jverifier.VerificationError):
        jmips.verify_mips_proof(jm, jvk, _tampered(theirs()))


@pytest.mark.slow
def test_forged_prev_rewind_rejected():
    """A memory shard whose previous_init_addr_bits rewinds below the
    previous shard's coverage satisfies its AIR, proves on the CPU through
    the port, and only the host chain check refuses it."""
    records = split_records()
    mem_idx = [i for i, r in enumerate(records) if r.num_cycles == 0]
    second = records[mem_idx[1]]
    true_prev = _packed(second.public_values.previous_init_addr_bits)
    assert true_prev - 1 > 0
    second.public_values.previous_init_addr_bits = addr_bits(true_prev - 1)
    machine = tmips.mips_machine(tconfig.dev_config())
    pk, vk = machine.setup(tasm.fibonacci_program(30))
    debug_constraints(machine, pk, copy.deepcopy(second))
    proof = machine.prove(pk, records, device="cpu")
    with pytest.raises(tverifier.VerificationError, match="chain"):
        tmips.verify_mips_proof(machine, vk, proof)


def test_memory_sweep_records_match_jax(monkeypatch):
    """memory_sweep_program(64) in shards of 2,048 cycles, with a threshold
    of 16 addresses and 48 events a memory shard: the same records in both
    packages, memory shards among them, and the fold committed."""
    monkeypatch.setenv("ZIREN_COMBINE_MEMORY_THRESHOLD", "16")
    monkeypatch.setenv("ZIREN_SPLIT_MEMORY", "48")
    ex, records = tmips.execute_sharded(mpg.memory_sweep_program(tasm, 64), 2048)
    jex, jrecords = jmips.execute_sharded(mpg.memory_sweep_program(jasm, 64), 2048)
    assert int(ex.global_clk) == int(jex.global_clk)
    assert ex.peek_register(11) == mpg.sweep_fold(64)
    assert len([r for r in records if r.num_cycles == 0]) == 2
    assert_same_records(records, jrecords)
    last = records[-1].public_values
    assert last.exit_code == 0
    assert list(last.committed_value_digest) == [mpg.sweep_fold(64)] + [0] * 7
