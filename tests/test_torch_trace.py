"""The port's spans (ziren_tpu_torch/trace.py) on the prove path, on the CPU.

Off, nothing is recorded and a span is one shared no-op; on, a
ProverClient.prove is one `request` root whose every span carries its id,
each child inside its parent's interval, with the stages the benchmark's
readers name (zkbench/attribution.py): the executor, the shard, its trace
generation by chip, the upload, the device key, the four stages of the
shard's body with each chip's permutation trace and quotient fold, the fetch
and the assembly; the benchmark's fold readers read them from a hand-made
run. The pools of the prover hand their workers the caller's span; two
threads proving at once get requests of their own; the proof bytes are the
same with and without recording.
The CUDA graph's capture and replay are on the card only (`cuda`).

    python -m pytest -q tests/test_torch_trace.py
"""

import os
import struct
import threading
from collections import Counter

import pytest
import torch

from ziren_tpu_torch import trace
from ziren_tpu_torch.executor import Executor
from ziren_tpu_torch.executor.asm import fibonacci_program
from ziren_tpu_torch.sdk import ProverClient
from ziren_tpu_torch.stark import machine as smachine
from ziren_tpu_torch.stark import tfused
from ziren_tpu_torch.stark.serialize import serialize_machine_proof

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

STAGES = ("request", "executor", "executor.finalize", "prove", "shard", "trace_wait",
          "tracegen", "tracegen.deps", "tracegen.trace", "upload", "device_pk",
          "body.commit_main", "body.perm", "perm.trace", "body.quotient", "quotient.fold",
          "body.open", "fetch", "assemble")


def check_tree(spans):
    """Every parent recorded, every child inside its parent's interval and
    of its request; returns the spans by id."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent is None:
            assert s.request == s.id
            continue
        up = by_id[s.parent]
        assert s.request == up.request, (s, up)
        assert up.t0_ns <= s.t0_ns and s.t1_ns <= up.t1_ns, (s, up)
    return by_id


@pytest.fixture(scope="module")
def sdk_proofs():
    """fibonacci(30) in one shard at the dev config on the CPU, proved with
    recording off and then on."""
    client = ProverClient(config="dev", device="cpu")
    pk, _vk = client.setup(fibonacci_program(30))
    off = client.prove(pk, shard_size=1 << 12)
    with trace.collect() as rec:
        on = client.prove(pk, shard_size=1 << 12)
    return pk, off, on, rec.spans


def test_off_records_nothing_and_costs_one_shared_object():
    assert trace.span("upload", bytes=3) is trace.OFF
    assert trace.span("shard") is trace.span("shard")
    with trace.span("upload", bytes=3) as s:
        s.set(more=1)
    assert s is trace.OFF
    with pytest.raises(KeyError):  # an exception passes through a span, on or off
        with trace.span("x"):
            raise KeyError("x")
    with trace.collect() as rec:
        assert isinstance(trace.span("x"), trace.Span)
        with pytest.raises(KeyError):
            with trace.span("x"):
                raise KeyError("x")
    assert trace.span("x") is trace.span("x")  # off again
    assert [(s.name, s.attrs) for s in rec.spans] == [("x", {"error": "KeyError"})]


def test_a_span_decorates_and_nests():
    @trace.span("outer")
    def outer():
        with trace.span("inner", k=1) as s:
            s.set(j=2)
        return 5

    assert outer() == 5  # decorated while off, nothing recorded
    with trace.collect() as a, trace.collect() as b:
        assert outer() == 5
    for rec in (a, b):  # every open recorder keeps every span
        inner, out = rec.spans
        assert (inner.name, inner.attrs, out.name) == ("inner", {"k": 1, "j": 2}, "outer")
        assert inner.parent == out.id and inner.request == out.request == out.id
        assert inner.thread == out.thread == threading.get_ident()
    with pytest.raises(TypeError):
        trace.span("outer", k=1)(outer)
    assert trace.seconds_by_chip([]) == {}


def test_tracing_changes_no_proof_byte(sdk_proofs):
    _pk, off, on, _spans = sdk_proofs
    assert serialize_machine_proof(off.proof) == serialize_machine_proof(on.proof)
    assert list(off.public_values.words) == list(on.public_values.words)


def test_a_prove_is_one_request_with_every_stage(sdk_proofs):
    pk, _off, on, spans = sdk_proofs
    roots = [s for s in spans if s.parent is None]
    assert [(r.name, r.attrs) for r in roots] == [("request",
                                                   {"call": "prove", "shard_size": 1 << 12})]
    by_id = check_tree(spans)
    assert {s.request for s in spans} == {roots[0].id}
    names = Counter(s.name for s in spans)
    assert set(STAGES) <= set(names), set(STAGES) - set(names)
    assert names["shard"] == len(on.proof.shard_proofs) == 1
    ex = next(s for s in spans if s.name == "executor")
    assert ex.attrs["shards"] == 1 and ex.attrs["cycles"] > 0
    prove = next(s for s in spans if s.name == "prove")
    assert prove.attrs == {"shards": 1, "path": "eager"}
    shard = next(s for s in spans if s.name == "shard")
    chips = on.proof.shard_proofs[0].chip_names
    assert shard.attrs["chips"] == len(chips) and shard.attrs["index"] == 0
    assert shard.attrs["rows"] == max(1 << ov.log_degree
                                      for ov in on.proof.shard_proofs[0].opened_values)
    upload = next(s for s in spans if s.name == "upload")
    assert upload.attrs["bytes"] > 0 and by_id[upload.parent] is shard
    assert next(s for s in spans if s.name == "device_pk").attrs["hit"] in (True, False)
    for stage in ("trace_wait", "tracegen", "upload", "device_pk", "body.commit_main",
                  "body.perm", "body.quotient", "body.open"):
        s = next(s for s in spans if s.name == stage)
        while s.name != "shard":
            s = by_id[s.parent]
    # one dependencies and one trace span (at least) for every chip proved
    for kind in ("tracegen.deps", "tracegen.trace"):
        assert set(chips) <= {s.attrs["chip"] for s in spans if s.name == kind}, kind
    assert set(trace.seconds_by_chip(spans)) >= set(chips)
    assert pk  # the key outlives the spans that named it


def test_a_fold_and_a_perm_trace_a_chip_a_shard(sdk_proofs):
    """`quotient.fold` (chip, constraints) under `body.quotient` and
    `perm.trace` (chip) under `body.perm`, one of each for every chip of
    every shard, in the shard's chip order; the folds take no more than
    their stage's host time."""
    pk, _off, on, spans = sdk_proofs
    by_id = check_tree(spans)
    machine = pk.machine
    for name, stage in (("quotient.fold", "body.quotient"), ("perm.trace", "body.perm")):
        mine = [s for s in spans if s.name == name]
        stages = [s for s in spans if s.name == stage]
        assert len(stages) == len(on.proof.shard_proofs)
        for st, sp in zip(stages, on.proof.shard_proofs):
            kids = sorted((s for s in mine if s.parent == st.id), key=lambda s: s.t0_ns)
            assert sorted(s.attrs["chip"] for s in kids) == sorted(sp.chip_names), name
            assert sum(s.t1_ns - s.t0_ns for s in kids) <= st.t1_ns - st.t0_ns
        assert all(by_id[s.parent].name == stage for s in mine)
        if name == "quotient.fold":
            for s in mine:
                assert set(s.attrs) == {"chip", "constraints"}
                assert s.attrs["constraints"] == machine.chip_by_name[s.attrs["chip"]].num_constraints
                assert s.attrs["constraints"] > 0
        else:
            assert all(set(s.attrs) == {"chip"} for s in mine)


# (id, parent, name, t0 ms, t1 ms, attrs) of a hand-made request of two
# shards on one thread, with the fold spans the benchmark's readers read
FOLD_SPANS = [
    (1, None, "request", 0, 1000, {}),
    (2, 1, "prove", 100, 990, {}),
    (3, 2, "shard", 100, 500, {"index": 0}),
    (4, 3, "body.perm", 110, 200, {}),
    (5, 4, "perm.trace", 110, 150, {"chip": "Cpu"}),
    (6, 3, "body.quotient", 200, 400, {}),
    (7, 6, "quotient.fold", 210, 300, {"chip": "Cpu", "constraints": 9}),
    (8, 6, "quotient.fold", 310, 340, {"chip": "Byte", "constraints": 2}),
    (9, 2, "shard", 500, 900, {"index": 1}),
    (10, 9, "body.quotient", 600, 800, {}),
    (11, 10, "quotient.fold", 600, 700, {"chip": "Cpu", "constraints": 9}),
]
# device operations (start ms, end ms): two under the first fold, one under
# the second, one under body.quotient alone, two under the third fold, one
# under perm.trace
FOLD_OPS = [(220, 230), (240, 250), (320, 330), (350, 360), (610, 620), (650, 660),
            (120, 130)]


def _fold_run(spans, ops):
    """A zkbench Run of one request (0 to 1 s) whose window holds `spans`."""
    from types import SimpleNamespace

    from zkbench import attribution, cells, devtrace
    from zkbench.harness import Request, Run

    ms = 1_000_000

    class Recorder:
        def __init__(self, kept):
            self.kept = kept

        def take(self):
            out, self.kept = self.kept, []
            return out

    attribution._recorder = Recorder([
        SimpleNamespace(id=i, parent=up, request=1, name=n, thread=7, t0_ns=a * ms,
                        t1_ns=b * ms, attrs=dict(at)) for i, up, n, a, b, at in spans])
    attribution._window = (None, None)
    dev = devtrace.DeviceTrace(events=[("k", a * ms, b * ms) for a, b in ops], t0=0,
                               t1=1000 * ms)
    cell = cells.Bench().cell("sha3chain-core.prove")
    return cell, Run(cell, [Request(0, 0.0, 1.0, 0, 1000 * ms)], 0.0, 1.0, [11088],
                     device=dev)


@pytest.mark.parametrize("kept", ["all", "none"])
def test_the_fold_readers(kept, monkeypatch):
    """prover.fold_s: 90 + 30 + 100 ms of folds in one request; prover.
    fold_ops_per_shard: 5 operations under folds over 2 shards. Without fold
    spans (a port that has none) both read None."""
    from zkbench import attribution

    monkeypatch.setattr(attribution, "_recorder", None)
    monkeypatch.setattr(attribution, "_collecting", None)
    monkeypatch.setattr(attribution, "_window", (None, None))
    monkeypatch.setattr(attribution, "last_run", None)
    spans = FOLD_SPANS if kept == "all" else [s for s in FOLD_SPANS if s[2] != "quotient.fold"]
    cell, run = _fold_run(spans, FOLD_OPS)
    names = [m["name"] for m in cell.per_layer]
    assert {"prover.fold_s", "prover.fold_ops_per_shard"} <= set(names)
    got = {m: cell.reader(m).read(run) for m in ("prover.fold_s", "prover.fold_ops_per_shard")}
    if kept == "all":
        assert got["prover.fold_s"] == pytest.approx(0.220)
        assert got["prover.fold_ops_per_shard"] == 2.5
    else:
        assert got == {"prover.fold_s": None, "prover.fold_ops_per_shard": None}
    monkeypatch.setattr(attribution, "_recorder", None)  # nothing recorded at all
    monkeypatch.setattr(attribution, "_window", (None, None))
    assert cell.reader("prover.fold_s").read(run) is None
    assert cell.reader("prover.fold_ops_per_shard").read(run) is None


def test_pool_workers_carry_the_request(tmp_path):
    """fix_shapes=True over two shards: the shards' traces are made in the
    prover's pool (generate_fixed), and fix_shape's pool on the host path;
    the workers' spans are under the span that handed them the work."""
    from ziren_tpu_torch.machine.mips import mips_machine
    from ziren_tpu_torch.stark.config import dev_config

    program = fibonacci_program(200)
    machine = mips_machine(dev_config())
    pk, _vk = machine.setup(program)

    def records():
        return Executor(program, shard_size=1 << 10).run_sharded()

    main = threading.get_ident()
    for device, handed_by in (("cpu", "prove"), ("host", "request")):
        with trace.collect() as rec, trace.span("request"):
            proof = smachine.StarkMachine.prove(machine, pk, records(), fix_shapes=True,
                                                device=device)
        assert len(proof.shard_proofs) >= 2
        spans = rec.spans
        by_id = check_tree(spans)
        root = next(s for s in spans if s.parent is None)
        assert {s.request for s in spans} == {root.id}
        made = [s for s in spans if s.name == "tracegen" and s.thread != main]
        assert len(made) >= len(proof.shard_proofs), device
        assert {by_id[s.parent].name for s in made} == {handed_by}
        kids = [s for s in spans if s.parent in {m.id for m in made}]
        assert kids and all(s.thread == by_id[s.parent].thread for s in kids)
        if device == "cpu":
            shards = [s for s in spans if s.name == "shard"]
            assert [s.attrs["index"] for s in shards] == list(range(len(proof.shard_proofs)))
            waits = [s for s in spans if s.name == "trace_wait"]
            assert [by_id[s.parent] for s in waits] == shards


def test_two_threads_proving_at_once_get_requests_of_their_own():
    client = ProverClient(config="dev", device="host")
    pk, _vk = client.setup(fibonacci_program(30))
    ready = threading.Barrier(2)
    got = {}

    def prove(i):
        ready.wait()
        got[i] = (threading.get_ident(), client.prove(pk, shard_size=1 << 12))

    with trace.collect() as rec:
        threads = [threading.Thread(target=prove, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = rec.spans
    check_tree(spans)
    roots = [s for s in spans if s.parent is None]
    assert sorted(r.thread for r in roots) == sorted(t for t, _ in got.values())
    assert [r.name for r in roots] == ["request", "request"]
    for r in roots:
        mine = [s for s in spans if s.request == r.id]
        assert {s.name for s in mine} >= {"request", "executor", "executor.finalize"}
    assert len({s.request for s in spans}) == 2
    # the two requests overlapped in time
    a, b = roots
    assert a.t0_ns < b.t1_ns and b.t0_ns < a.t1_ns


def test_the_pc_trace_is_whole_when_run_sharded_returns(tmp_path, monkeypatch):
    """ZIREN_TRACE_FILE: one big-endian pc a constrained cycle; the file is
    closed when run() and run_sharded() return (and on an error), and both
    write the same bytes for the same program."""
    program = fibonacci_program(40)
    paths = {}
    for how in ("run", "run_sharded"):
        paths[how] = tmp_path / f"{how}.bin"
        monkeypatch.setenv("ZIREN_TRACE_FILE", str(paths[how]))
        ex = Executor(program, shard_size=1 << 6)
        getattr(ex, how)()
        assert ex._trace_buf is None
    data = paths["run_sharded"].read_bytes()
    assert data == paths["run"].read_bytes()
    pcs = [v[0] for v in struct.iter_unpack(">I", data)]
    assert len(pcs) == ex.global_clk and pcs[0] == program.pc_start

    class Stop(Exception):
        pass

    monkeypatch.setenv("ZIREN_TRACE_FILE", str(tmp_path / "stopped.bin"))
    ex = Executor(program, shard_size=1 << 6)
    buf = ex._trace_buf
    monkeypatch.setattr(ex, "execute_cycle", lambda: (_ for _ in ()).throw(Stop()))
    with pytest.raises(Stop):
        ex.run_sharded()
    assert buf.closed and ex._trace_buf is None


@pytest.mark.cuda
def test_fused_capture_once_a_shape_and_a_replay_a_shard(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA graph has no CPU mode")
    from ziren_tpu_torch.machine.mips import mips_machine
    from ziren_tpu_torch.stark.config import dev_config

    program = fibonacci_program(400)
    machine = mips_machine(dev_config())
    pk, _vk = machine.setup(program)
    records = Executor(program, shard_size=1 << 10).run_sharded()
    monkeypatch.setenv("ZIREN_FUSED", "1")
    tfused._MEM.clear()
    with trace.collect() as rec:
        proof = smachine.prove(machine, pk, records, fix_shapes=True)
    spans = rec.spans
    by_id = check_tree(spans)
    n = len(proof.shard_proofs)
    assert n >= 2 and next(s for s in spans if s.name == "prove").attrs["path"] == "fused"
    captures = [s for s in spans if s.name == "fused.capture"]
    replays = [s for s in spans if s.name == "fused.replay"]
    shapes = {tuple(sp.chip_names) for sp in proof.shard_proofs}  # padded: a chip set a shape
    assert len(captures) == len(shapes)
    assert len(replays) == n - len(shapes)  # a shape's first shard is its warm-up's proof
    for s in captures + replays:
        while s.name != "shard":
            s = by_id[s.parent]
