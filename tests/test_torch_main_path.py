"""The port's main path on the CPU: one function makes a record's traces
(stark/shape.py:record_traces) and one loop proves the shards
(stark/machine.py:prove).

A record's synthetic events are emitted once, whichever path traces it
first and whichever counts its rows after. Every path that makes traces
records one `tracegen` span a record, with a `tracegen.deps` and a
`tracegen.trace` span for each chip the record includes: the host prover,
the canonical padding (fix_records_to_clusters) and the loop's eager,
fused and mesh (two CPU members) bodies. The three fill one `stats` schema
and give the same proof bytes (tests/test_torch_sharded.py holds the fused
mesh), and the canonical path proves byte-equal to the JAX package's.
"""

import os

import pytest
import torch

import ziren_tpu.executor.asm as jasm
import ziren_tpu.machine.mips as jmips
import ziren_tpu.recursion.shape_universe as jsu
import ziren_tpu.stark.config as jconfig
import ziren_tpu.stark.serialize as jser
from ziren_tpu.executor import Executor as JExecutor
from ziren_tpu_torch import trace
from ziren_tpu_torch.device import Mesh
from ziren_tpu_torch.executor import Executor
from ziren_tpu_torch.executor.asm import alu_torture2_program, fibonacci_program
from ziren_tpu_torch.machine.mips import execute, mips_machine
from ziren_tpu_torch.recursion.shape_universe import fix_records_to_clusters
from ziren_tpu_torch.stark import machine as smachine
from ziren_tpu_torch.stark import shape, tprover
from ziren_tpu_torch.stark.config import dev_config
from ziren_tpu_torch.stark.prover import prove_shard
from ziren_tpu_torch.stark.serialize import serialize_shard_proof

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

N, SHARD_SIZE = 200, 1 << 10  # two shards
STATS = {"trace_wait_s", "dispatch_s", "fetch_s", "assemble_s"}
# name: (the body is fused, members of a mesh or None for one device)
BODIES = {"eager": (False, None), "fused": (True, None), "mesh": (False, 2)}


def _records(program):
    return Executor(program, shard_size=SHARD_SIZE).run_sharded()


def _synthetic(record) -> int:
    return sum(len(v) for v in record.synthetic.values())


def check_tracegen(machine, records, spans):
    """One `tracegen` span a record, and under each a `tracegen.deps` and a
    `tracegen.trace` span for every chip its record includes (one trace
    span a chip)."""
    made = [s for s in spans if s.name == "tracegen"]
    assert len(made) == len(records)
    want, got = [], []
    for r in records:
        want.append(sorted(c.name for c in machine.chips if c.air.included(r)))
    for s in made:
        kids = [k for k in spans if k.parent == s.id]
        traced = sorted(k.attrs["chip"] for k in kids if k.name == "tracegen.trace")
        assert {k.attrs["chip"] for k in kids if k.name == "tracegen.deps"} == set(traced)
        assert s.attrs["chips"] == len(traced)
        got.append(traced)
    assert sorted(got) == sorted(want)


@pytest.fixture(scope="module")
def mips():
    program = fibonacci_program(N)
    machine = mips_machine(dev_config())
    pk, vk = machine.setup(program)
    return program, machine, pk, vk


@pytest.fixture(scope="module")
def proved(mips):
    """The two shards through each body of the loop, recorded: (records,
    spans, stats, proof bytes) by body."""
    program, machine, pk, _vk = mips
    out = {}
    for name, (fused, members) in BODIES.items():
        records = _records(program)
        assert len(records) == 2
        where = {"devices": Mesh(["cpu"] * members, "shard")} if members else {"device": "cpu"}
        stats: dict = {}
        with pytest.MonkeyPatch.context() as mp, trace.collect() as rec:
            if fused:
                mp.setenv("ZIREN_FUSED", "1")
            else:
                mp.delenv("ZIREN_FUSED", raising=False)
            proof = smachine.prove(machine, pk, records, fix_shapes=True, stats=stats, **where)
        out[name] = (records, rec.spans, stats,
                     [serialize_shard_proof(sp) for sp in proof.shard_proofs])
    return out


def test_synthetic_events_once_a_record():
    """A record traced by the device prover's dispatch (_named_traces) and
    counted by the cost model after it (estimate_targets) keeps its 19
    synthetic events, and every chip its row count."""
    program = alu_torture2_program()
    machine = mips_machine(dev_config())
    _ex, record = execute(program)
    named = tprover._named_traces(machine, record)
    rows = {c.name: c.air.num_rows(record) for c, _t in named}
    assert _synthetic(record) == 19
    shape.estimate_targets(machine, [record])
    shape.estimate_lde_area(machine, record)
    assert _synthetic(record) == 19
    assert {c.name: c.air.num_rows(record) for c, _t in named} == rows
    # and the traces made again from the record are the same
    again = shape.record_traces(machine, record)
    assert [c.name for c, _t in again] == [c.name for c, _t in named]
    assert all((a == b).all() for (_c, a), (_d, b) in zip(again, named))


def test_the_host_prover_traces_a_record_once(mips):
    program, machine, pk, _vk = mips
    record = _records(program)[0]
    base = machine.config.challenger()
    pk.vk.observe_into(base)
    with trace.collect() as rec:
        prove_shard(machine, pk, record, base)
    check_tracegen(machine, [record], rec.spans)


def test_the_canonical_padding_traces_a_record_once(mips):
    program, machine, _pk, _vk = mips
    records = _records(program)
    with trace.collect() as rec:
        fix_records_to_clusters(machine, records)
    check_tracegen(machine, records, rec.spans)


@pytest.mark.parametrize("name", list(BODIES))
def test_each_body_traces_a_record_once(proved, mips, name):
    records, spans, _stats, _bytes = proved[name]
    check_tracegen(mips[1], records, spans)


def test_one_stats_schema_and_one_proof(proved):
    """Every body fills the same keys, with `member` on a mesh and `built`
    and `replay_ms` on the fused body (no replay events on the CPU), and
    proves the same bytes."""
    want = proved["eager"][3]
    for name, (records, _spans, stats, got) in proved.items():
        fused, members = BODIES[name]
        assert got == want, name
        extra = ({"member"} if members else set()) | ({"built", "replay_ms"} if fused else set())
        assert set(stats) == STATS | extra, name
        assert len(stats["trace_wait_s"]) == len(stats["dispatch_s"]) == len(records)
        if members:
            assert stats["member"] == [i % members for i in range(len(records))]
        if fused:
            assert stats["replay_ms"] == []
            for b in stats["built"]:
                assert set(b) == {"capture_s", "instantiate_s", "nodes", "pool_bytes",
                                  "launches"}


def test_the_canonical_proof_is_the_jax_packages(mips):
    """Padded to its cluster shape (sdk prove(canonical=True)), the first
    shard proves on the CPU byte-equal to the JAX package's host prover."""
    program, machine, pk, _vk = mips
    jprogram = jasm.fibonacci_program(N)
    jm = jmips.mips_machine(jconfig.dev_config())
    jpk, _ = jm.setup(jprogram)
    jrecords = JExecutor(jprogram, shard_size=SHARD_SIZE).run_sharded()[:1]
    jsu.fix_records_to_clusters(jm, jrecords)
    want = [jser.serialize_shard_proof(sp) for sp in jm.prove(jpk, jrecords).shard_proofs]
    records = _records(program)[:1]
    fix_records_to_clusters(machine, records)
    proof = machine.prove(pk, records, device="cpu")
    assert [serialize_shard_proof(sp) for sp in proof.shard_proofs] == want
