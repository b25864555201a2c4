"""CPU tests of what the benchmark reads from the port's own spans
(attribution.py and the readers tracegen.deps_s, prover.upload_s and
prover.device_ops_per_shard), on a hand-made run: one request of one shard
on the proving thread, a worker's span beside it, and seven device
operations, with times in milliseconds.

    python -m pytest -q zkbench/tests/test_zkbench_program_spans.py
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from zkbench import attribution, cells, devtrace, harness
from zkbench.harness import Request, Run

MS = 1_000_000
MAIN, WORKER = 101, 202

# (id, parent, name, thread, t0 ms, t1 ms, attrs)
SPANS = [
    (1, None, "request", MAIN, 0, 1000, {"call": "prove"}),
    (2, 1, "executor", MAIN, 10, 200, {}),
    (3, 1, "prove", MAIN, 200, 990, {}),
    (4, 3, "shard", MAIN, 210, 900, {"index": 0}),
    (5, 4, "tracegen", MAIN, 220, 500, {}),
    (6, 5, "tracegen.deps", MAIN, 230, 300, {"chip": "Cpu"}),
    (7, 5, "tracegen.deps", MAIN, 300, 320, {"chip": "Cpu"}),
    (8, 5, "tracegen.trace", MAIN, 320, 490, {"chip": "Cpu"}),
    (9, 4, "upload", MAIN, 500, 560, {"bytes": 64}),
    (10, 4, "body.commit_main", MAIN, 560, 700, {}),
    (11, 4, "body.open", MAIN, 700, 890, {}),
    (12, 3, "fetch", MAIN, 900, 950, {}),
    (13, 3, "assemble", MAIN, 950, 980, {}),
    (14, 3, "tracegen", WORKER, 230, 260, {}),  # a pool's worker, beside the prove
    (15, None, "request", MAIN, 1100, 1150, {}),  # after the window: not read
]
# (name, start ms, end ms) and where each starts: upload, commit_main, open,
# open, fetch, the request alone, between requests
OPS = [("a", 520, 540), ("b", 600, 650), ("c", 710, 720), ("d", 720, 730),
       ("e", 905, 915), ("f", 995, 998), ("g", 1100, 1110)]


def span(i, parent, name, thread, t0, t1, attrs):
    return SimpleNamespace(id=i, parent=parent, request=1 if i < 15 else 15, name=name,
                           thread=thread, t0_ns=t0 * MS, t1_ns=t1 * MS, attrs=dict(attrs))


class FakeRecorder:
    def __init__(self, spans):
        self.spans = spans

    def take(self):
        out, self.spans = self.spans, []
        return out


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(attribution, "_recorder", FakeRecorder([span(*s) for s in SPANS]))
    monkeypatch.setattr(attribution, "_window", (None, None))
    dev = devtrace.DeviceTrace(events=[(n, s * MS, e * MS) for n, s, e in OPS], t0=0,
                               t1=1200 * MS)
    req = Request(0, 0.0, 1.0, 0, 1000 * MS)
    return Run(cells.Bench().cell("fib-core.prove-n58218"), [req], 0.0, 1.0, [100],
               device=dev)


def read(metric, run):
    return cells.Bench().cell("fib-core.prove-n58218").reader(metric).read(run)


def test_the_three_readers(run):
    assert read("tracegen.deps_s", run) == pytest.approx(0.090)  # 70 + 20 ms
    assert read("prover.upload_s", run) == pytest.approx(0.060)
    # a, b, c, d under the shard; e, still queued when the shard ended, under fetch
    assert read("prover.device_ops_per_shard", run) == 5.0


def test_the_readers_read_nothing_without_the_ports_spans(run, monkeypatch):
    monkeypatch.setattr(attribution, "_recorder", None)
    for m in ("tracegen.deps_s", "prover.upload_s", "prover.device_ops_per_shard"):
        assert read(m, run) is None
    monkeypatch.setattr(attribution, "_recorder", FakeRecorder([]))
    monkeypatch.setattr(attribution, "_window", (None, None))
    for m in ("tracegen.deps_s", "prover.upload_s", "prover.device_ops_per_shard"):
        assert read(m, run) is None


def test_the_window_holds_its_requests_spans_alone(run):
    spans = attribution.window_spans(run)
    assert sorted(s.id for s in spans) == list(range(1, 15))
    assert attribution.window_spans(run) is spans and attribution.last_run is run


def test_program_seconds_total_and_self(run):
    got = attribution.program_seconds(attribution.window_spans(run), 1)
    assert got["request"]["total"] == pytest.approx(1.0)
    assert got["request"]["self"] == pytest.approx(0.020)  # less executor and prove
    assert got["shard"]["self"] == pytest.approx(0.020)  # 690 less 280, 60, 140, 190
    # the worker's 30 ms count to tracegen, and not against prove's own time
    assert got["tracegen"]["total"] == pytest.approx(0.310)
    assert got["tracegen"]["self"] == pytest.approx(0.020 + 0.030)
    assert got["prove"]["self"] == pytest.approx(0.020)  # 790 less 690, 50, 30
    assert list(got)[0] == "request"


def test_device_seconds_by_the_span_each_operation_started_under(run):
    tl = attribution.Timeline(attribution.window_spans(run))
    assert tl.main == MAIN
    got = attribution.device_by_span(run.device, tl)
    assert got == pytest.approx({"upload": 0.020, "body.commit_main": 0.050,
                                 "body.open": 0.020, "fetch": 0.010, "request": 0.003,
                                 "between requests": 0.010})
    assert attribution.ops_under(run.device, tl, "shard") == 4
    assert attribution.ops_under(run.device, tl, "prove") == 5
    assert tl.at(MAIN, 231 * MS).attrs["chip"] == "Cpu" and tl.at(WORKER, 231 * MS).id == 14
    assert tl.at(MAIN, 1000 * MS) is None  # a span's end is outside it


def test_idle_seconds_by_the_innermost_span_of_the_proving_thread(run):
    tl = attribution.Timeline(attribution.window_spans(run))
    got = attribution.idle_by_span(run.device, tl)
    want = {"request": 0.017, "executor": 0.190, "prove": 0.020, "shard": 0.020,
            "tracegen": 0.020, "tracegen.deps[Cpu]": 0.090, "tracegen.trace[Cpu]": 0.170,
            "upload": 0.040, "body.commit_main": 0.090, "body.open": 0.170, "fetch": 0.040,
            "assemble": 0.030, "between requests": 0.190}
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(1.2 - run.device.busy_s)


def test_attributed_shares(run):
    tl = attribution.Timeline(attribution.window_spans(run))
    got = attribution.attributed(run.device, tl)
    assert got["device_pct"] == pytest.approx(100 * 100 / 103)  # f started under request
    assert got["idle_pct"] == pytest.approx(100 * 880 / 897)  # 17 of 897 ms under request
    fields = attribution.fields(run)
    assert set(fields) == {"program_s", "device_by_span", "idle_by_span", "attributed"}
    assert fields["device_by_span"][0] == ["body.commit_main", pytest.approx(0.05)]
    assert len(fields["idle_by_span"]) == 13 and fields["attributed"] == got


def test_operations_still_queued_when_the_shard_ends_are_counted(run):
    # a graph replayed by one host call: the shard's span ends before its
    # operations start on the card, and fetch waits for them
    run.device = devtrace.DeviceTrace(
        events=[("k1", 901 * MS, 910 * MS), ("k2", 910 * MS, 930 * MS),
                ("copy", 930 * MS, 940 * MS), ("later", 1100 * MS, 1110 * MS)],
        t0=0, t1=1200 * MS)
    assert read("prover.device_ops_per_shard", run) == 3.0
    tl = attribution.Timeline(attribution.window_spans(run))
    assert attribution.ops_under(run.device, tl, "shard") == 0


def test_the_recorder_opens_in_a_traced_run_alone(monkeypatch):
    from ziren_tpu_torch import trace

    monkeypatch.setattr(attribution, "_recorder", None)
    monkeypatch.setattr(attribution, "_collecting", None)
    monkeypatch.setattr(attribution, "_window", (None, None))
    reader = cells.Bench().cell("fib-core.prove-n58218").reader("prover.upload_s")
    assert reader.WRAPS == [] and attribution._recorder is None and not trace._on

    def run_cell(trace):  # stands in for harness.run_cell, which asks for WRAPS
        return getattr(reader, "WRAPS", None)
    monkeypatch.setattr(harness, "run_cell", run_cell)
    assert run_cell(False) == [] and attribution._recorder is None and not trace._on
    t0 = trace.time.time_ns()
    try:
        assert run_cell(True) == [] and attribution._recorder is not None and trace._on
        with trace.span("upload"):
            pass
    finally:
        got = attribution.window_spans(
            Run(cells.Bench().cell("fib-core.prove-n58218"),
                [Request(0, 0.0, 1.0, t0, trace.time.time_ns())], 0.0, 1.0, [100]))
    assert [s.name for s in got] == ["upload"]
    assert attribution._recorder is None and not trace._on  # closed once read
