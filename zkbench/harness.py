"""One run of one cell: set-up, the measured window, the check.

    result = run_cell(Bench().cell("fib-core.prove-n58218"), seed=7, seconds=30,
                      trace=False)

Set-up builds the guest and its proving key through ProverClient.setup and
makes one warm request of the cell's own kind and size, which builds or
loads the kernels and fills the prover's caches. The window is a closed loop
of one client: a request is sent while the window's seconds have not run
out, the next when the last returns; the window closes at the last return.
With trace=True the port's functions that the cell's metrics name are timed
(spans.py) and torch.profiler records the card over the window.

The check runs after the window, once the peak memory is read and the
program's state is freed: every request's committed words, the digest in its
proof and its executor's cycle count against the reference
(reference/<guest>.py), and every proof the window returned verified in full
by the reference's verifier (reference/verify.py). Each count must be 0."""

from __future__ import annotations

import gc
import os
import sys
import time
from dataclasses import dataclass, field

from . import devtrace
from .cells import CHECKOUT
from .generator import Traffic
from .spans import STATS_TARGET, Spans

# the spans every traced run records, by which the idle gaps are labelled
BASE_SPANS = [
    ("executor", "ziren_tpu_torch.executor.executor:Executor.run_sharded"),
    ("prove", STATS_TARGET),
    ("issue", "ziren_tpu_torch.stark.machine:dispatch_shard"),
    ("tracegen", "ziren_tpu_torch.stark.tprover:_named_traces"),
    ("fetch", "ziren_tpu_torch.stark.machine:to_host"),
    ("assemble", "ziren_tpu_torch.stark.machine:finish"),
]
CACHE = os.path.join(CHECKOUT, ".zkbench_cache")


def pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths. The
    port's own kernels build into ziren_tpu_torch/_build/ and its native
    host libraries into native/, both inside the checkout already."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)


@dataclass
class Request:
    index: int
    t0: float
    t1: float
    t0_ns: int
    t1_ns: int
    words: list | None = None  # the public values the SDK returned
    digest: list | None = None  # the committed digest in the proof's last shard
    proof_bytes: bytes | None = None
    pow_witnesses: list = field(default_factory=list)
    shards: int = 0
    error: str | None = None
    clk: int | None = None  # the executor's global_clk, where read
    buffers: list = field(default_factory=list)
    out: object = None  # the SDK's answer, until the check takes what it judges


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: object
    requests: list  # the window's Requests
    t0: float  # the window's start, perf_counter seconds
    setup_s: float
    cycles: list  # the reference's cycle count of each window request
    spans: Spans | None = None
    launches: dict | None = None  # kernels.SHAPES over the window
    device: devtrace.DeviceTrace | None = None
    tracegen_by_chip: dict | None = None

    @property
    def done(self) -> list:
        return [r for r in self.requests if r.error is None]

    @property
    def t1(self) -> float:
        return max(r.t1 for r in self.requests) if self.requests else self.t0


def _labeller(spans: Spans, requests: list) -> list:
    """[(start_ns, end_ns, label)]: the host's time cut where any span starts
    or ends, each piece labelled by the innermost span the host was in,
    "request" inside a request and no span, else "between requests"."""
    events = [(n, s, e) for n, s, e in spans.events] + [
        ("request", r.t0_ns, r.t1_ns) for r in requests]
    cuts = sorted({t for _n, s, e in events for t in (s, e)})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) // 2
        inside = [(s, n) for n, s, e in events if s <= mid < e]
        pieces.append((a, b, max(inside)[1] if inside else "between requests"))
    return pieces


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             since_start=None, prove_hook=None) -> dict:
    """One run; returns the result's fields. `device` "cpu" runs the port's
    plain PyTorch kernels, for the tests; `prove_hook(prove) -> prove` lets
    a test break the timed path underneath."""
    started = time.perf_counter()
    since_start = since_start or (lambda: time.perf_counter() - started)
    pin_caches()
    import torch

    from ziren_tpu_torch.executor import asm
    from ziren_tpu_torch.executor.executor import Executor
    from ziren_tpu_torch.sdk import ProverClient, ZirenStdin
    from ziren_tpu_torch.stark.serialize import serialize_machine_proof

    cuda = device == "cuda"
    if cuda:
        from ziren_tpu_torch import kernels

        kernels.load()
        torch.cuda.reset_peak_memory_stats()
    traffic = Traffic(cell, seed)
    cfg = cell.config
    program = traffic.guest.build(asm, **traffic.args)
    client = ProverClient(config=cfg["stark_config"], device=None if cuda else device)
    pk, _vk = client.setup(program)

    clocks: list = []  # the executor's global_clk after each run_sharded
    run_sharded = Executor.run_sharded

    def counted(self, *a, **kw):
        try:
            return run_sharded(self, *a, **kw)
        finally:
            clocks.append(int(self.global_clk))
    Executor.run_sharded = counted

    def prove(pk_, stdin):
        return client.prove(pk_, stdin, shard_size=int(cfg["shard_size"]))
    if prove_hook is not None:
        prove = prove_hook(prove)

    def request(i: int) -> Request:
        buffers = traffic.inputs(i)
        stdin = ZirenStdin()
        for b in buffers:
            stdin.write_slice(b)
        n_clk = len(clocks)
        t0, t0_ns = time.perf_counter(), time.time_ns()
        try:
            out = prove(pk, stdin)
            err = None
        except Exception as e:  # a request that raises is unanswered, not a crash
            out, err = None, f"{type(e).__name__}: {e}"
        if cuda:
            torch.cuda.synchronize()
        return Request(i, t0, time.perf_counter(), t0_ns, time.time_ns(), error=err,
                       clk=clocks[-1] if len(clocks) > n_clk else None, buffers=buffers,
                       out=out)

    spans = clock = dev = None
    try:
        warm = request(-1)
        if trace:
            from .frozen.tracegen_clock import TraceGenClock

            spans = Spans()
            targets = list(BASE_SPANS)
            for m in cell.per_layer:
                targets += list(getattr(cell.reader(m["name"]), "WRAPS", []))
            spans.install(targets)
            clock = TraceGenClock(pk.machine)
            if cuda:
                dev = devtrace.DeviceTrace()
        if cuda:
            torch.cuda.synchronize()
            kernels.reset_launches()
        if dev is not None:
            dev.start()
        setup_s = since_start()
        t_w = time.perf_counter()
        reqs = []
        while not reqs or time.perf_counter() - t_w < seconds:
            reqs.append(request(len(reqs)))
        if dev is not None:
            dev.stop()
        launches = ({k: dict(v) for k, v in kernels.SHAPES.items()} if cuda else None)
    finally:
        if spans is not None:
            spans.remove()
        if clock is not None:
            clock.remove()
        Executor.run_sharded = run_sharded
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # what is judged, taken from the outputs; then the program's state goes
    from .reference.verify import digest_words

    out = None
    for r in [warm, *reqs]:
        out, r.out = r.out, None
        if out is None:
            continue
        shards = out.proof.shard_proofs
        r.shards = len(shards)
        r.words = [int(w) for w in out.public_values.words]
        r.digest = digest_words(shards[-1].public_values) if shards else None
        r.pow_witnesses = [int(sp.opening_proof.pow_witness) for sp in shards]
        if r.index >= 0:  # the window's requests; set-up's warm one is checked on its words
            r.proof_bytes = serialize_machine_proof(out.proof)
    del client, pk, _vk, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    expected = cell.expected()
    want = {r.index: expected.expected(r.buffers, **traffic.args) for r in [warm, *reqs]}
    run = Run(cell, reqs, t_w, setup_s, [want[r.index]["cycles"] for r in reqs], spans,
              launches, dev, clock.take() if clock is not None else None)
    result = {"metrics": {}, "attempted": len(reqs), "failed": sum(r.error is not None for r in reqs)}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"]).read(run)
        if v is not None:
            result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if dev is not None:
        result["device"].update(busy_s=dev.busy_s, window_s=dev.window_s)
        result["breakdown"] = {
            "device_ops": devtrace.top(dev.seconds_by_kernel()),
            "idle_gaps": devtrace.top(dev.idle_by_label(_labeller(spans, reqs)))}
    if trace:
        result["tracegen_by_chip"] = devtrace.top(run.tracegen_by_chip or {}, 40)
        result["spans_missing"] = spans.missing
    result["requests"] = [[r.index, round(r.t1 - r.t0, 6), r.shards] for r in reqs]

    t_check = time.perf_counter()
    checks, why = judge(cell, traffic, [warm, *reqs], want)
    result["check_s"] = time.perf_counter() - t_check
    result["why_not"] = why[:10]
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def judge(cell, traffic, reqs: list, want: dict) -> tuple:
    """The numbers compared, each {"value", "limit"}, and what was wrong."""
    from .reference.verify import Judge

    why = []
    unanswered = [r for r in reqs if r.error is not None]
    why += [f"request {r.index}: {r.error}" for r in unanswered]
    answered = [r for r in reqs if r.error is None]
    words = [r for r in answered if r.words != want[r.index]["words"]]
    why += [f"request {r.index}: words {r.words} != {want[r.index]['words']}" for r in words]
    padded = {i: w["words"] + [0] * (8 - len(w["words"])) for i, w in want.items()}
    digest = [r for r in answered if r.digest != padded[r.index]]
    why += [f"request {r.index}: digest {r.digest} != {padded[r.index]}" for r in digest]
    cycles = [r for r in answered if r.clk is not None and r.clk != want[r.index]["cycles"]]
    why += [f"request {r.index}: {r.clk} cycles != {want[r.index]['cycles']}" for r in cycles]
    verified = [r for r in answered if r.proof_bytes is not None]
    ref = Judge(traffic.guest, traffic.args, cell.config["fri"])
    errors = ref.verify([r.proof_bytes for r in verified],
                        [want[r.index]["words"] for r in verified],
                        workers=max(1, min(sum(r.shards for r in verified),
                                           (os.cpu_count() or 2) - 1, 8)))
    rejected = [(r, e) for r, e in zip(verified, errors) if e is not None]
    why += [f"request {r.index}: proof rejected: {e}" for r, e in rejected]
    # a window whose requests all went unanswered verified nothing
    checks = {
        "unanswered": {"value": len(unanswered), "limit": 0},
        "words_wrong": {"value": len(words), "limit": 0},
        "digest_wrong": {"value": len(digest), "limit": 0},
        "cycles_wrong": {"value": len(cycles), "limit": 0},
        "proofs_rejected": {"value": len(rejected), "limit": 0},
        "none_verified": {"value": int(not verified), "limit": 0},
    }
    print(f"checked {len(reqs)} requests ({sum(r.clk is not None for r in reqs)} cycle counts "
          f"read), verified {len(verified)} proofs in full", file=sys.stderr)
    return checks, why
