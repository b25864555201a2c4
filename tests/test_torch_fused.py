"""The fused shard prover (ziren_tpu_torch.stark.tfused) on the CPU.

With device="cpu", named by the caller, the fused path runs the shard's
device body (tprover.prove_body) without capture, over the static buffers
that a CUDA graph reads on the card. Its proofs are byte-equal to the JAX
package's host prover and to the port's eager path, a refilled buffer set
proves the shard put into it, and after the warm-up the body neither reads a
value back to the host nor builds a tensor from host data: what a CUDA graph
needs. Only the plain grind, the CPU's stand-in for K4, reads back one flag
a batch. The graph itself, and K4, run on the card only (chip_smoke.py
phase 10, tests/test_torch_kernels.py)."""

import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_stark_engine import FibonacciAir, Record, fib_pv
from test_torch_folder import PortFibonacciAir

import ziren_tpu.executor.asm as jasm
import ziren_tpu.machine.mips as jmips
import ziren_tpu.stark.config as jconfig
import ziren_tpu.stark.machine as jmachine
import ziren_tpu.stark.prover as jprover_host
import ziren_tpu.stark.serialize as jser
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.machine as tmachine
import ziren_tpu_torch.stark.serialize as tser
from ziren_tpu_torch import kernels
from ziren_tpu_torch.ops import tchallenger
from ziren_tpu_torch.ops import tposeidon2 as tp2
from ziren_tpu_torch.stark import carry, tfused, tprover

# Under pytest-xdist each worker keeps to one torch thread: the workers
# already fill the cores, and torch's thread pool on top of them slows
# every worker down.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = torch.device("cpu")


def _base(machine, pk):
    base = machine.config.challenger()
    pk.vk.observe_into(base)
    return base


def _fused_shard(machine, pk, record):
    """The _FusedShard that the fused path built for this record."""
    chips, _traces, domains, _pv = tprover.shard_layout(machine, record)
    return tfused._MEM[tfused._machine_key(machine, pk, chips, domains, CPU)]


def _prove_again(fs, machine, pk, record):
    """Load `record` into fs's buffers, prove it, assemble the proof bytes."""
    chips, traces, domains, pv = tprover.shard_layout(machine, record)
    fs.fill(traces, pv)
    fetch, events = fs()
    assert events is None  # no graph on the CPU
    d = {"chips": chips, "trace_domains": domains, "public_values": pv,
         "fri": machine.config.fri, "meta": fs.meta}
    return tser.serialize_shard_proof(tprover.finish(pk, d, fetch.numpy()))


class HostSyncTrap(TorchDispatchMode):
    """Fails on a read of a tensor's value into Python (.item(), int(t):
    aten::_local_scalar_dense) and on a tensor made from host data. The
    plain versions of the kernels are the CPU's stand-ins for one launch
    each on the card, and the trap stands aside inside them: the plain
    grind reads one flag back a batch, the plain Poseidon2 is pure tensor
    work whose many small operations would only slow the trap down."""

    def __init__(self):
        super().__init__()
        self.aside = 0  # depth of the plain kernels' calls, which nest
        self._patch = pytest.MonkeyPatch()

    def __enter__(self):
        def aside(fn):
            def wrapped(*args, **kw):
                self.aside += 1
                try:
                    return fn(*args, **kw)
                finally:
                    self.aside -= 1
            return wrapped

        def refuse(name, fn):
            def wrapped(*args, **kw):
                if not self.aside:
                    raise AssertionError(f"the body built a tensor from host data: {name}")
                return fn(*args, **kw)
            return wrapped

        mp = self._patch
        mp.setattr(tchallenger, "_grind", aside(tchallenger._grind))
        for name in ("permute_plain", "hash_rows_plain", "compress_levels_plain"):
            mp.setattr(tp2, name, aside(getattr(tp2, name)))
        for name in ("as_tensor", "tensor", "from_numpy"):
            mp.setattr(torch, name, refuse(f"torch.{name}", getattr(torch, name)))
        for name in ("numpy", "tolist"):
            mp.setattr(torch.Tensor, name, refuse(f"Tensor.{name}", getattr(torch.Tensor, name)))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patch.undo()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.aside:
            if func is torch.ops.aten._local_scalar_dense.default:
                raise AssertionError("the body read a tensor's value back to the host")
            if func is torch.ops.aten.lift_fresh.default:
                raise AssertionError("the body built a tensor from host data: torch.tensor")
        return func(*args, **(kwargs or {}))


def _trapped_body(monkeypatch):
    """Runs every prove_body under a HostSyncTrap from now on."""
    body = tprover.prove_body

    def trapped(*args, **kw):
        with HostSyncTrap():
            return body(*args, **kw)

    monkeypatch.setattr(tprover, "prove_body", trapped)


@pytest.fixture(scope="module")
def mips30():
    """fibonacci(30) at the dev config: the JAX package's host proof, the
    port's eager proof (its body warms the caches of the shape), and the
    port's fused proof with its body under a HostSyncTrap, as bytes."""
    jprog = jasm.fibonacci_program(30)
    jm = jmips.mips_machine(jconfig.dev_config())
    jpk, _jvk = jm.setup(jprog)
    _ex, jrec = jmips.execute(jprog)
    jax_bytes = jser.serialize_shard_proof(
        jprover_host.prove_shard(jm, jpk, jrec, _base(jm, jpk)))

    prog = tasm.fibonacci_program(30)
    machine = tmips.mips_machine(tconfig.dev_config())
    pk, vk = machine.setup(prog)
    _ex, record = tmips.execute(prog)
    eager = tprover.prove_shard(machine, pk, record, _base(machine, pk), "cpu")
    with pytest.MonkeyPatch.context() as mp:
        _trapped_body(mp)
        mp.setenv("ZIREN_FUSED", "1")
        fused = tmachine.prove(machine, pk, [record], device="cpu")
    return {"jax": jax_bytes, "eager": tser.serialize_shard_proof(eager),
            "fused": [tser.serialize_shard_proof(sp) for sp in fused.shard_proofs],
            "machine": machine, "vk": vk, "program": prog}


def test_mips_fused_matches_host_and_eager(mips30):
    """A MIPS shard (preprocessed chips, the Global chip's sums read from the
    device main) through the fused path: byte-equal to the JAX package's
    host prover and to the port's eager path; the port's verifier takes the
    JAX package's bytes carried across. The fused body ran under the trap,
    after the eager body had warmed the caches: no value read back, no
    tensor made from host data, as a CUDA graph needs."""
    assert mips30["fused"] == [mips30["jax"]]
    assert mips30["eager"] == mips30["jax"]
    assert tmips.verify_mips_proof(
        mips30["machine"], mips30["vk"],
        carry.machine_proof_from_shard_bytes([mips30["jax"]]),
        pc_start=mips30["program"].pc_start)


def test_the_trap_catches_a_read_back():
    with pytest.raises(AssertionError, match="read a tensor's value"):
        with HostSyncTrap():
            int(torch.ones(()) + 1)
    for make in (lambda: torch.as_tensor(np.arange(3)), lambda: torch.tensor([1, 2])):
        with pytest.raises(AssertionError, match="host data"):
            with HostSyncTrap():
                make()
    with HostSyncTrap():  # a plain kernel reads back inside, as the CPU grind does
        tp2.permute_plain(torch.zeros((2, 16), dtype=torch.int64))
    assert torch.as_tensor(np.arange(3)).tolist() == [0, 1, 2]  # undone on leaving


class _TwoStart(FibonacciAir):
    """FibonacciAir whose trace starts from the record's first two public values."""

    def generate_trace(self, record, output):
        a, b = record.public_values[:2]
        rows = []
        for _ in range(record.n):
            rows.append([a, b])
            a, b = b, (a + b) % 2130706433
        return np.asarray(rows, np.uint32)


class _PortTwoStart(PortFibonacciAir):
    generate_trace = _TwoStart.generate_trace


def test_engine_fused_matches_host_and_eager(monkeypatch):
    """The engine AIR through the fused path (ZIREN_FUSED=1): byte-equal to
    the JAX package's host prover and to the port's eager path."""
    jm = jmachine.StarkMachine(jconfig.dev_config(), [FibonacciAir()], num_public_values=3)
    jpk, _ = jm.setup()
    tm = tmachine.StarkMachine(tconfig.dev_config(), [PortFibonacciAir()], num_public_values=3)
    tpk, tvk = tm.setup()
    record = Record(n=32, pv=fib_pv(32))
    want = jser.serialize_shard_proof(
        jprover_host.prove_shard(jm, jpk, Record(n=32, pv=fib_pv(32)), _base(jm, jpk)))
    eager = tprover.prove_shard(tm, tpk, record, _base(tm, tpk), "cpu")
    monkeypatch.setenv("ZIREN_FUSED", "1")
    fused = tmachine.prove(tm, tpk, [record], device="cpu")
    assert tser.serialize_shard_proof(eager) == want
    assert [tser.serialize_shard_proof(sp) for sp in fused.shard_proofs] == [want]
    assert tm.verify(tvk, fused)


def test_static_buffers_take_a_second_shard(monkeypatch):
    """Refilled with a second shard's inputs, the same _FusedShard proves
    that shard, not the first: its traces and public values come from the
    buffers, nothing of the first shard is baked in."""
    jm = jmachine.StarkMachine(jconfig.dev_config(), [_TwoStart()], num_public_values=3)
    jpk, _ = jm.setup()
    tm = tmachine.StarkMachine(tconfig.dev_config(), [_PortTwoStart()], num_public_values=3)
    tpk, tvk = tm.setup()
    a, b = 3, 5
    for _ in range(31):
        a, b = b, (a + b) % 2130706433
    first, second = Record(n=32, pv=fib_pv(32)), Record(n=32, pv=[3, 5, b])
    host = [jser.serialize_shard_proof(jprover_host.prove_shard(
        jm, jpk, Record(n=32, pv=list(r.public_values)), _base(jm, jpk)))
        for r in (first, second)]
    assert host[0] != host[1]
    monkeypatch.setenv("ZIREN_FUSED", "1")
    proof = tmachine.prove(tm, tpk, [first], device="cpu")
    assert tser.serialize_shard_proof(proof.shard_proofs[0]) == host[0]
    fs = _fused_shard(tm, tpk, first)
    assert _fused_shard(tm, tpk, second) is fs  # one shape, one _FusedShard
    with pytest.MonkeyPatch.context() as mp:
        _trapped_body(mp)
        assert _prove_again(fs, tm, tpk, second) == host[1]
        assert _prove_again(fs, tm, tpk, first) == host[0]
    # both shards in one call: the first builds, the second refills
    both = tmachine.prove(tm, tpk, [second, first], device="cpu")
    assert [tser.serialize_shard_proof(sp) for sp in both.shard_proofs] == host[::-1]
    assert tm.verify(tvk, both)


def test_fused_route_under_ziren_fused(monkeypatch):
    """ZIREN_FUSED=1 sends each shard of StarkMachine.prove's device branch
    and of stark.machine.prove to tfused.dispatch_fused; off by default."""
    tm = tmachine.StarkMachine(tconfig.dev_config(), [PortFibonacciAir()], num_public_values=3)
    tpk, tvk = tm.setup()
    record = Record(n=16, pv=fib_pv(16))
    calls = []
    real = tfused.dispatch_fused

    def spy(machine, pk, record, member):
        calls.append(member.device)
        return real(machine, pk, record, member)

    monkeypatch.setattr(tfused, "dispatch_fused", spy)
    monkeypatch.delenv("ZIREN_FUSED", raising=False)
    assert not tfused.enabled()
    eager = tm.prove(tpk, [record], device="cpu")
    assert calls == []
    monkeypatch.setenv("ZIREN_FUSED", "1")
    assert tfused.enabled()
    via_method = tm.prove(tpk, [record], device="cpu")
    via_function = tmachine.prove(tm, tpk, [record], device="cpu")
    assert calls == [CPU, CPU]
    want = [tser.serialize_shard_proof(sp) for sp in eager.shard_proofs]
    for proof in (via_method, via_function):
        assert [tser.serialize_shard_proof(sp) for sp in proof.shard_proofs] == want
    assert tm.verify(tvk, via_method)
    # the host prover is not routed
    tm.prove(tpk, [record], device="host")
    assert calls == [CPU, CPU]


def test_fused_needs_the_gpu_by_default(monkeypatch):
    """device=None is the GPU: without one the fused path raises and never
    goes on on the CPU or eagerly."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    tm = tmachine.StarkMachine(tconfig.dev_config(), [PortFibonacciAir()], num_public_values=3)
    tpk, _ = tm.setup()
    monkeypatch.setenv("ZIREN_FUSED", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmachine.prove(tm, tpk, [Record(n=16, pv=fib_pv(16))])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.prove(tpk, [Record(n=16, pv=fib_pv(16))])


def test_replays_credit_the_capture_histogram():
    """Inside recording() a wrapper's count goes to the capture's histogram
    (a capture launches nothing); each replay credits it to LAUNCHES and
    SHAPES, and to REPLAYED, which the wrappers' own launches leave alone."""
    saved = (dict(kernels.LAUNCHES), dict(kernels.REPLAYED),
             {k: dict(v) for k, v in kernels.SHAPES.items()})
    kernels.reset_launches()
    try:
        with kernels.recording() as hist:
            kernels._count("permute", 1)
            kernels._count("permute", 1)
            kernels._count("grind", (4, 16))
        assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
        assert hist["permute"] == {1: 2} and hist["grind"] == {(4, 16): 1}
        kernels.credit(hist)
        kernels.credit(hist)
        kernels._count("hash_rows", (8, 8))
        assert kernels.LAUNCHES == {"hash_rows": 1, "permute": 4, "compress_levels": 0,
                                    "grind": 2}
        assert kernels.REPLAYED == {"hash_rows": 0, "permute": 4, "compress_levels": 0,
                                    "grind": 2}
        assert kernels.SHAPES["permute"] == {1: 4} and kernels.SHAPES["grind"] == {(4, 16): 2}
    finally:
        kernels.reset_launches()
        kernels.LAUNCHES.update(saved[0])
        kernels.REPLAYED.update(saved[1])
        for k, v in saved[2].items():
            kernels.SHAPES[k].update(v)


def test_index_tensors_are_uploaded_once():
    """The host-built gather indices of a shape are cached by content: a
    second prove of the shape finds every one of them."""
    from ziren_tpu_torch.ops import tfield as tf

    idx = np.array([3, 1, 2])
    a = tf.index(idx, CPU)
    assert tf.index(idx.copy(), CPU) is a
    assert tf.index(np.array([3, 1, 2, 0]), CPU) is not a
    assert a.dtype == torch.int64 and a.tolist() == [3, 1, 2]


def _engine():
    tm = tmachine.StarkMachine(tconfig.dev_config(), [PortFibonacciAir()], num_public_values=3)
    tpk, tvk = tm.setup()
    return tm, tpk, tvk


def _host_bytes(tm, tpk, n):
    return [tser.serialize_shard_proof(sp) for sp in
            tm.prove(tpk, [Record(n=n, pv=fib_pv(n))], device="host").shard_proofs]


def test_a_build_holds_up_no_built_shape(monkeypatch):
    """While one thread builds a new shape (its warm-up and capture held on
    an event), a prove of a shape already built finishes: the table of
    graphs is locked only to look up or claim a key. The build then ends and
    proves its own shard."""
    tm, tpk, tvk = _engine()
    monkeypatch.setenv("ZIREN_FUSED", "1")
    tmachine.prove(tm, tpk, [Record(n=16, pv=fib_pv(16))], device="cpu")
    gate, entered = threading.Event(), threading.Event()
    real = tfused._FusedShard.warm_and_capture

    def held(self):
        entered.set()
        assert gate.wait(timeout=120)
        return real(self)

    monkeypatch.setattr(tfused._FusedShard, "warm_and_capture", held)
    out = {}

    def prove(name, n):
        out[name] = tmachine.prove(tm, tpk, [Record(n=n, pv=fib_pv(n))], device="cpu")

    building = threading.Thread(target=prove, args=("new", 128))  # a shape no other test builds
    building.start()
    try:
        assert entered.wait(timeout=60)
        built = threading.Thread(target=prove, args=("built", 16))
        built.start()
        built.join(timeout=30)
        assert not built.is_alive(), "a prove of a built shape waited for another's build"
        assert building.is_alive()
    finally:
        gate.set()
        building.join(timeout=120)
    assert not building.is_alive()
    for name, n in (("built", 16), ("new", 128)):
        assert [tser.serialize_shard_proof(sp) for sp in out[name].shard_proofs] == \
            _host_bytes(tm, tpk, n)
        assert tm.verify(tvk, out[name])


def test_two_threads_build_one_shape_once(monkeypatch):
    """Two threads that meet one unbuilt shape at once: one builds it, the
    other waits for that build and replays it (on the CPU: runs its body
    over the buffers); both proofs are right."""
    tm, tpk, tvk = _engine()
    monkeypatch.setenv("ZIREN_FUSED", "1")
    builds = []
    real = tfused._FusedShard.warm_and_capture

    def counted(self):
        builds.append(threading.get_ident())
        time.sleep(0.5)  # the other thread meets the key meanwhile
        return real(self)

    monkeypatch.setattr(tfused._FusedShard, "warm_and_capture", counted)
    start = threading.Barrier(2)
    out = []

    def prove():
        start.wait(timeout=30)
        out.append(tmachine.prove(tm, tpk, [Record(n=256, pv=fib_pv(256))],
                                  device="cpu"))  # a shape no other test builds

    threads = [threading.Thread(target=prove) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and len(out) == 2
    assert len(builds) == 1
    want = _host_bytes(tm, tpk, 256)
    for proof in out:
        assert [tser.serialize_shard_proof(sp) for sp in proof.shard_proofs] == want
