"""The port's Global chip against the JAX package's, on the CPU.

The port's GlobalChip builds its events as arrays, lifts them to the curve
once a record (generate_dependencies keeps them on the record for
generate_trace) and adds the points in one native call
(core/septic_native.py, csrc/septic_sum.cpp), with the Python
`_running_sums` where the library cannot be built or loaded. The native sum
is held against the Python one on seeded points, and the chip's trace and
byte counts against the JAX package's, on records that each package's own
executor makes from the same program.
"""

import numpy as np
import pytest

import ziren_tpu.executor.asm as jasm
import ziren_tpu.executor.executor as jexecutor
import ziren_tpu.executor.record as jrecord
import ziren_tpu.executor.split as jsplit
import ziren_tpu.machine.global_chip as jglobal
import ziren_tpu.machine.mips as jmips
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.executor.executor as texecutor
import ziren_tpu_torch.executor.record as trecord
import ziren_tpu_torch.executor.split as tsplit
import ziren_tpu_torch.machine.global_chip as tglobal
import ziren_tpu_torch.machine.mips as tmips
from ziren_tpu_torch import trace
from ziren_tpu_torch.core import septic as S
from ziren_tpu_torch.core import septic_native
from ziren_tpu_torch.machine.layout import fixed_height
from ziren_tpu_torch.tools import precompile_programs as pp

RECORDS = ("empty", "sha_chain", "keccak_chain", "memory_split")


def _records(name, monkeypatch):
    """(JAX record, port record) pairs of one program, every shard."""
    if name == "empty":
        return [(jrecord.ExecutionRecord(None), trecord.ExecutionRecord(None))]
    out = []
    for asm, mips, ex, split in ((jasm, jmips, jexecutor, jsplit),
                                 (tasm, tmips, texecutor, tsplit)):
        if name == "memory_split":  # standalone memory shards: mem_init and mem_final
            records = ex.Executor(asm.fibonacci_program(30), shard_size=40).run_sharded()
            records = split.finalize_memory(
                records, split.SplitOpts(memory=3, combine_memory_threshold=4))
        elif name == "sha_chain":  # a deferral threshold of two rows: deferred shards
            monkeypatch.setenv("ZIREN_SPLIT_DEFERRED", "2")
            _ex, records = mips.execute_sharded(pp.sha256_chain_program(asm, 2)[0], 1 << 16)
        else:
            _ex, records = mips.execute_sharded(pp.keccak_chain_program(asm, 4)[0], 1 << 16)
        out.append(records)
    assert len(out[0]) == len(out[1]) > 0
    if name != "keccak_chain":  # shards without Cpu rows, deferred or memory alone
        assert any(r.num_cycles == 0 for r in out[1])
    return list(zip(*out))


def _run(chip, record):
    record.byte_counts = {}
    chip.generate_dependencies(record, record)
    mat = chip.generate_trace(record, record)
    return mat, {k: v for k, v in record.byte_counts.items() if v}


def _points(n, seed):
    """n points lifted from seeded messages, each negated on a random send."""
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 1 << 30, (n, 7), dtype=np.uint32)
    xs, ys, _offs = S.lift_x_batch(msgs) if n else (msgs, msgs, None)
    sends = rng.integers(0, 2, n).astype(np.uint32)
    return xs, np.where(sends[:, None] == 1, S.sneg(ys), ys)


def test_the_native_sum_is_built():
    assert septic_native.available()


@pytest.mark.parametrize("n", [0, 1, 2, 4096])
def test_native_running_sum_matches_python(n):
    xs, ys = _points(n, 1000 + n)
    want = tglobal._running_sums(S.digest_zero(), xs, ys)
    got = septic_native.running_sums(S.digest_zero(), xs, ys)
    for w, g in zip(want, got):
        assert g.dtype == np.uint32 and g.shape == w.shape and np.array_equal(g, w)


def test_native_zero_difference_matches_python():
    """A point whose x is the running sum's: the inverse of 0 is 0 in both."""
    start = S.digest_zero()
    xs, ys = _points(3, 7)
    xs = np.stack([start[0], xs[1], xs[1], xs[2]])
    ys = np.stack([ys[0], ys[1], ys[1], ys[2]])
    want = tglobal._running_sums(start, xs, ys)
    got = septic_native.running_sums(start, xs, ys)
    assert not want[0][0].any()  # the degenerate row's slope
    for w, g in zip(want, got):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("records", RECORDS)
def test_global_chip_matches_jax(records, monkeypatch):
    jchip, tchip = jglobal.GlobalChip(), tglobal.GlobalChip()
    for jrec, trec in _records(records, monkeypatch):
        assert len(tchip._events(trec)[0]) == tchip.num_rows(trec)
        jmat, jcounts = _run(jchip, jrec)
        tmat, tcounts = _run(tchip, trec)
        assert tmat.dtype == jmat.dtype and np.array_equal(tmat, jmat)
        assert tcounts == jcounts


def test_trace_alone_and_again_match(monkeypatch):
    """generate_trace with no dependencies first, after them, and again at a
    fixed height (as stark/shape.py regenerates it) agree."""
    chip = tglobal.GlobalChip()
    for _jrec, rec in _records("keccak_chain", monkeypatch):
        alone = chip.generate_trace(rec, rec)
        assert getattr(rec, "_global_lifted", None) is None
        chip.generate_dependencies(rec, rec)
        kept = [a.copy() for a in rec._global_lifted]
        after = chip.generate_trace(rec, rec)
        with fixed_height(2 * after.shape[0]):
            taller = chip.generate_trace(rec, rec)
        assert np.array_equal(alone, after)
        assert np.array_equal(taller[: after.shape[0]], after)
        pad = taller[after.shape[0]:]
        assert (pad == pad[0]).all() and np.array_equal(pad[0, -14:], after[-1, -14:])
        assert all(np.array_equal(a, b) for a, b in zip(kept, rec._global_lifted))


def test_python_fallback_gives_the_same_trace(monkeypatch):
    chip = tglobal.GlobalChip()
    (_jrec, rec), *_ = _records("keccak_chain", monkeypatch)
    seen = {}
    for how in ("native", "python"):
        if how == "python":
            monkeypatch.setattr(septic_native, "available", lambda: False)
        with trace.collect() as rec_spans, trace.span("tracegen.trace", chip="Global"):
            seen[how] = chip.generate_trace(rec, rec)
        (sp,) = rec_spans.spans
        assert sp.attrs == {"chip": "Global", "rows": chip.num_rows(rec), "sum": how}
    assert np.array_equal(seen["native"], seen["python"])
