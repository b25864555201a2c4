"""The port's SHA-256 precompile chips against the JAX package's, on the CPU.

The port's ShaCompressChip and ShaExtendChip make their byte lookups and
trace rows as arrays over all of a record's events; the JAX package's make
them one event, one round and one byte at a time. Each record below is made
by both packages' executors from the same program, and each chip's trace
matrix and the nonzero entries of its byte counts are compared exactly. A
call counter on the byte-count helper holds the array form: each chip's
generate_dependencies counts a number of times that does not grow with the
number of events.
"""

import numpy as np
import pytest

import ziren_tpu.executor.asm as jasm
import ziren_tpu.executor.record as jrecord
import ziren_tpu.machine.mips as jmips
import ziren_tpu.machine.sha_compress as jcompress
import ziren_tpu.machine.sha_extend as jextend
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.executor.record as trecord
import ziren_tpu_torch.machine.byte as tbyte
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.machine.sha_compress as tcompress
import ziren_tpu_torch.machine.sha_extend as textend
from ziren_tpu.executor.opcode import SyscallCode
from ziren_tpu_torch.tools import precompile_programs as pp

CHIPS = {"ShaCompress": (jcompress.ShaCompressChip, tcompress.ShaCompressChip),
         "ShaExtend": (jextend.ShaExtendChip, textend.ShaExtendChip)}
SHA = (int(SyscallCode.SHA_COMPRESS), int(SyscallCode.SHA_EXTEND))
# (rounds of the chain, shard size, deferral threshold): one compress event;
# four in one shard; four in shards of 64 cycles, split with a deferral
# threshold of two rows, so that deferred records hold a single family and
# accesses whose last touch was in an earlier shard (prev_shard != shard)
CHAINS = {"one_event": (1, 1 << 16, None), "chain4": (4, 1 << 16, None),
          "deferred_split": (4, 64, "2")}


def _records(name, monkeypatch):
    """The records of both packages that hold SHA-256 events, in order."""
    if name == "empty":
        return [(jrecord.ExecutionRecord(None), trecord.ExecutionRecord(None))]
    n, shard_size, deferred = CHAINS[name]
    if deferred is not None:
        monkeypatch.setenv("ZIREN_SPLIT_DEFERRED", deferred)
    out = []
    for asm, mips in ((jasm, jmips), (tasm, tmips)):
        program, _digest = pp.sha256_chain_program(asm, n)
        _ex, records = mips.execute_sharded(program, shard_size)
        out.append([r for r in records if any(r.precompile_events.get(s) for s in SHA)])
    assert len(out[0]) == len(out[1]) > 0
    return list(zip(*out))


def _run(chip, record):
    record.byte_counts = {}
    chip.generate_dependencies(record, record)
    mat = chip.generate_trace(record, record)
    return mat, {k: v for k, v in record.byte_counts.items() if v}


@pytest.mark.parametrize("chip", CHIPS)
@pytest.mark.parametrize("records", ["empty", *CHAINS])
def test_sha_chip_matches_jax(chip, records, monkeypatch):
    jchip, tchip = (c() for c in CHIPS[chip])
    pairs = _records(records, monkeypatch)
    if records == "deferred_split":
        # the split leaves a record of each family alone, and accesses that
        # cross shards
        crossing = [ev for _j, t in pairs for ev in tchip._events(t)
                    if any(acc[3] != ev["shard"] for acc in
                           ev.get("reads", []) + ev.get("h_reads", []) + ev.get("w_reads", []))]
        assert crossing and len(pairs) > 2
    for jrec, trec in pairs:
        assert len(tchip._events(trec)) == len(jchip._events(jrec))
        jmat, jcounts = _run(jchip, jrec)
        tmat, tcounts = _run(tchip, trec)
        assert tmat.dtype == jmat.dtype and np.array_equal(tmat, jmat)
        assert tcounts == jcounts


@pytest.mark.parametrize("chip", CHIPS)
def test_sha_dependencies_count_in_arrays(chip, monkeypatch):
    calls = []
    inner = tbyte.count

    def counted(*args, **kw):
        calls.append(args[1])
        return inner(*args, **kw)

    for mod in (tbyte, tcompress, textend):
        monkeypatch.setattr(mod, "count", counted)
    tchip = CHIPS[chip][1]()
    made = {}
    for n in (1, 8):
        program, _digest = pp.sha256_chain_program(tasm, n)
        _ex, (record,) = tmips.execute_sharded(program, 1 << 16)
        events = len(tchip._events(record))
        calls.clear()
        tchip.generate_dependencies(record, record)
        made[n] = (events, len(calls))
    assert made[8][0] == 8 * made[1][0]
    assert made[1][1] == made[8][1] > 0
