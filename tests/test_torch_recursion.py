"""The port's recursion path (ziren_tpu_torch.recursion) against the JAX
package's, on the CPU, across the package border, tolerance 0: these are
proof bytes. Each package traces its own DSL program and builds its own
machine and keys from the same inputs; the port proves with its torch shard
prover (device="cpu": the plain versions of the kernels), the JAX package
with its host prover (its backend on a machine without an accelerator);
the proofs are compared as bytes and each package's verifier takes the
other's bytes. The whole compress of a two-shard proof is held the same way
in tests/test_torch_compress.py."""

import os

import numpy as np
import pytest
import torch

from test_stark_engine import FibonacciAir, Record, fib_pv
from test_torch_folder import PortFibonacciAir

import ziren_tpu.executor.asm as jasm
import ziren_tpu.machine.mips as jmips
import ziren_tpu.recursion.dsl as jdsl
import ziren_tpu.recursion.machine as jrmachine
import ziren_tpu.recursion.mips_pipeline as jmp
import ziren_tpu.recursion.pipeline as jpl
import ziren_tpu.stark.config as jconfig
import ziren_tpu.stark.machine as jmachine
import ziren_tpu.stark.proof as jproof
import ziren_tpu.stark.serialize as jser
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.recursion.dsl as tdsl
import ziren_tpu_torch.recursion.machine as trmachine
import ziren_tpu_torch.recursion.mips_pipeline as tmp
import ziren_tpu_torch.recursion.pipeline as tpl
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.machine as tmachine
import ziren_tpu_torch.stark.proof as tproof
import ziren_tpu_torch.stark.serialize as tser
from ziren_tpu_torch.core.challenger import DuplexChallenger
from ziren_tpu_torch.stark import carry

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _arith(dsl):
    """Base and extension arithmetic, a traced challenger, a select."""
    t = dsl.Tracer(num_inputs=3)
    a, b, c = t.input(0), t.input(1), t.input(2)
    d = (a + b) * c - 5
    t.assert_eq(d * d.inv(), t.const(1))
    e1 = t.ext_const([1, 2, 3, 4])
    e2 = t.ext_from([a, b, c, d])
    e3 = (e1 * e2).inv() * (e1 * e2)
    t.assert_eq(dsl.Felt(t, e3.r), t.const(1))
    ch = dsl.TracedChallenger(t)
    for v in (a, b, c, d):
        ch.observe(v)
    s = ch.sample()
    t.output(d)
    t.output(s)
    t.output(t.select(t.const(1), s, a))
    return t.program(), [3, 4, 5], ()


def _sample_bits(dsl):
    """A hinted bit decomposition of a challenger sample (the Hint chip)."""
    rng = np.random.default_rng(11)
    values = [int(v) for v in rng.integers(0, 2130706433, 8)]
    host = DuplexChallenger()
    for v in values:
        host.observe(v)
    s_host = host.sample()
    t = dsl.Tracer(num_inputs=len(values))
    ch = dsl.TracedChallenger(t)
    for i in range(len(values)):
        ch.observe(t.input(i))
    t.output(ch.sample_bits(10))
    return t.program(), values, [(s_host >> i) & 1 for i in range(31)]


@pytest.mark.parametrize("build", [_arith, _sample_bits])
def test_recursion_shard_matches_jax(build):
    """One recursion shard: the port's torch prover, the port's host prover
    and the JAX package's host prover give one proof, byte for byte, and
    each package's verifier takes the other's bytes."""
    jprog, inputs, hints = build(jdsl)
    jm, _jpk, jvk, jpf, jout = jrmachine.prove_recursion(jprog, inputs, hints=hints)
    jbytes = jser.serialize_shard_proof(jpf.shard_proofs[0])

    tprog, inputs, hints = build(tdsl)
    tm, _tpk, tvk, tpf, tout = trmachine.prove_recursion(tprog, inputs, hints=hints,
                                                         device="cpu")
    _m, _pk, _vk, hpf, _out = trmachine.prove_recursion(tprog, inputs, hints=hints,
                                                        device="host")
    data = tser.serialize_shard_proof(tpf.shard_proofs[0])
    assert tout == jout == tdsl.interpret(tprog, inputs, hints=hints)
    assert data == tser.serialize_shard_proof(hpf.shard_proofs[0])
    assert data == jbytes
    assert np.array_equal(tvk.commit, jvk.commit)
    assert tm.verify(tvk, carry.machine_proof_from_shard_bytes([jbytes]))
    assert jm.verify(jvk, jproof.MachineProof([jser.deserialize_shard_proof(data)]))


@pytest.fixture(scope="module")
def mips30():
    """fibonacci(30) at the dev config, one shard: proved once by the JAX
    package's host prover and carried into the port as bytes."""
    jprog = jasm.fibonacci_program(30)
    jm, _jpk, jvk, jpf, _ex = jmips.prove_program(jprog, config=jconfig.dev_config())
    assert len(jpf.shard_proofs) == 1
    shard_bytes = [jser.serialize_shard_proof(sp) for sp in jpf.shard_proofs]
    tprog = tasm.fibonacci_program(30)
    tm = tmips.mips_machine(tconfig.dev_config())
    _tpk, tvk = tm.setup(tprog, extra_observations=[tprog.pc_start])  # as prove_program does
    assert np.array_equal(tvk.commit, jvk.commit)
    return (jm, jvk, jpf), (tm, tvk, carry.machine_proof_from_shard_bytes(shard_bytes))


def test_lift_shard_matches_jax(mips30):
    """One lift of a MIPS shard proof: the same recursion vk and the same
    proof bytes from both packages; verified by both."""
    (jm, jvk, jpf), (tm, tvk, tpf) = mips30
    jrm, jrvk, jsp = jmp.lift_shard(jm, jvk, jpf.shard_proofs[0])
    trm, trvk, tsp = tmp.lift_shard(tm, tvk, tpf.shard_proofs[0], device="cpu")
    data = tser.serialize_shard_proof(tsp)
    assert np.array_equal(trvk.commit, jrvk.commit)
    assert data == jser.serialize_shard_proof(jsp)
    assert [int(v) for v in tsp.public_values] == tmp.shard_rpv(tm, tvk, tpf.shard_proofs[0])
    assert trm.verify(trvk, tproof.MachineProof([tsp]))
    assert jrm.verify(jrvk, jproof.MachineProof([jser.deserialize_shard_proof(data)]))
    # a one-shard compress under the lift registry is that lift
    registry = tmp.build_lift_registry(tm, tvk, tpf.shard_proofs)
    _rm, crvk, csp = tmp.compress(tm, tvk, tpf, registry=registry, device="cpu")
    assert np.array_equal(crvk.commit, trvk.commit)
    assert [int(v) for v in csp.public_values[tmp.RPV_VK_ROOT : tmp.RPV_VK_ROOT + 8]] == [
        int(v) for v in registry.root]


NEEDS_THE_GPU = ["prove_recursion", "lift_shard", "compress", "pipeline.lift", "pipeline.join",
                 "pipeline.compress", "shrink"]


@pytest.fixture(scope="module")
def small_shard():
    prog, inputs, _hints = _arith(tdsl)
    rm, _pk, rvk, rpf, _out = trmachine.prove_recursion(prog, inputs, device="cpu")
    return prog, inputs, rm, rvk, rpf


@pytest.mark.parametrize("entry", NEEDS_THE_GPU)
def test_recursion_without_a_device_needs_the_gpu(mips30, small_shard, entry):
    """`device` defaults to the GPU in every entry point that proves:
    without one they raise and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    _jax, (tm, tvk, tpf) = mips30
    prog, inputs, rm, rvk, rpf = small_shard
    sp, rsp = tpf.shard_proofs[0], rpf.shard_proofs[0]
    calls = {
        "prove_recursion": lambda: trmachine.prove_recursion(prog, inputs),
        "lift_shard": lambda: tmp.lift_shard(tm, tvk, sp),
        "compress": lambda: tmp.compress(
            tm, tvk, tpf, registry=tmp.build_lift_registry(tm, tvk, tpf.shard_proofs)),
        "pipeline.lift": lambda: tpl.lift(rm, rvk, rsp),
        "pipeline.join": lambda: tpl.join((rm, rvk, rsp), (rm, rvk, rsp)),
        "pipeline.compress": lambda: tpl.compress(rm, rvk, rpf),
        "shrink": lambda: tpl.shrink(rm, rvk, rsp),
    }
    assert sorted(calls) == sorted(NEEDS_THE_GPU)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_generic_pipeline_matches_jax_and_wraps_on_the_host():
    """pipeline.compress (lift, lift, join) and shrink of a two-shard proof
    of a plain AIR, byte-equal to the JAX package's; wrap_bn254 proves under
    the outer config, which only the host prover takes, with no device
    argument."""
    jm = jmachine.StarkMachine(jconfig.dev_config(), [FibonacciAir()], num_public_values=3)
    tm = tmachine.StarkMachine(tconfig.dev_config(), [PortFibonacciAir()], num_public_values=3)
    records = lambda: [Record(n=16, pv=fib_pv(16)), Record(n=32, pv=fib_pv(32))]
    jpk, jvk = jm.setup()
    tpk, tvk = tm.setup()
    jpf = jm.prove(jpk, records())
    tpf = tm.prove(tpk, records(), device="cpu")

    jrm, jrvk, jroot = jpl.compress(jm, jvk, jpf)
    trm, trvk, troot = tpl.compress(tm, tvk, tpf, device="cpu")
    assert tser.serialize_shard_proof(troot) == jser.serialize_shard_proof(jroot)
    assert np.array_equal(trvk.commit, jrvk.commit)

    _jsm, jsvk, jspf, _ = jpl.shrink(jrm, jrvk, jroot)
    tsm, tsvk, tspf, _ = tpl.shrink(trm, trvk, troot, device="cpu")
    tssp = tspf.shard_proofs[0]
    assert tser.serialize_shard_proof(tssp) == jser.serialize_shard_proof(jspf.shard_proofs[0])
    assert np.array_equal(tsvk.commit, jsvk.commit)
    assert tsm.verify(tsvk, tspf)
    assert [int(v) for v in tssp.public_values] == tpl.lift_digest(trvk, troot)

    wm, wvk, wpf, _ = tpl.wrap_bn254(tsm, tsvk, tssp, config=tconfig.outer_dev_config())
    assert isinstance(wpf.shard_proofs[0].commitment.main, int)  # a BN254 Fr commitment
    assert [int(v) for v in wpf.shard_proofs[0].public_values] == tpl.lift_digest(tsvk, tssp)
    assert wm.verify(wvk, wpf)


def test_bench_instrument_and_tree_registry(mips30):
    """tools/compress_bench.py: `instrument` times a compress without
    changing it and puts every function back; `tree_registry` holds the vk
    of the tree's every node at the full registry's height."""
    from ziren_tpu_torch.tools import compress_bench as cb

    _jax, (tm, tvk, tpf) = mips30
    patched = lambda: (tmp.lift_shard, tmp.join, tmp._prove_cached, tpl.lift, tpl._prove_cached,
                       tpl._setup_cached, tmachine.StarkMachine.prove)
    before = patched()
    with cb.instrument() as times:
        assert all(a is not b for a, b in zip(patched(), before))
        registry = cb.tree_registry(tm, tvk, tpf.shard_proofs, None)
        _rm, rvk, _sp = tmp.compress(tm, tvk, tpf, registry=registry, device="cpu")
    assert patched() == before
    assert registry.depth == 6 and len(registry.commits) == 1
    registry.membership(rvk.commit)
    assert [len(times[k]) for k in ("lift", "enum_lift")] == [1, 2] and "join" not in times
    lift = times["lift"][0]
    parts = [lift[k] for k in ("trace_verifier_s", "setup_s", "witness_s", "device_pk_s", "prove_s")]
    assert all(p >= 0 for p in parts) and abs(sum(parts) - lift["total_s"]) < 1e-6
    assert lift["prove_s"] > 0 and "machine" not in times["enum_lift"][0]
    assert [c[0] for c in lift["machine"]].count("RecPoseidon2") == 1
    assert "prove 0." in cb.summary(times["enum_lift"])
