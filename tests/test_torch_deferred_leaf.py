"""The deferred leaf alone (recursion/deferred.py:deferred_leaf) in the port
against the JAX package, on the CPU, tolerance 0: proofs are compared as
bytes, public values as words.

A dev-config compressed root of fibonacci(8) is made once by the JAX
package (its host prover, one lift under the lift-only registry,
mips_pipeline.build_lift_registry) and carried into the port as bytes; the
port rebuilds the lift's recursion machine and vk from its own traced
program. Each package then proves the leaf that verifies that root and
folds its claim into the deferred chain: the port with its torch shard
prover on the CPU, timed by tools/compress_bench.py:instrument. The rest of
the composition is held in tests/test_torch_deferred.py."""

import os

import numpy as np
import pytest
import torch

import ziren_tpu.executor.asm as jasm
import ziren_tpu.machine.mips as jmips
import ziren_tpu.recursion.deferred as jD
import ziren_tpu.recursion.mips_pipeline as jmp
import ziren_tpu.stark.config as jconfig
import ziren_tpu.stark.proof as jproof
import ziren_tpu.stark.serialize as jser
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.recursion.deferred as tD
import ziren_tpu_torch.recursion.mips_pipeline as tmp
import ziren_tpu_torch.recursion.pipeline as tpl
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.serialize as tser
from ziren_tpu_torch.stark import carry, tprover
from ziren_tpu_torch.tools import compress_bench as cb

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sub_root():
    """fibonacci(8)'s compressed root, made by the JAX package, and the
    same root in the port: (rec_machine, rec_vk, final shard proof) each."""
    jprog = jasm.fibonacci_program(8)
    jm = jmips.mips_machine(jconfig.dev_config())
    jpk, jvk = jm.setup(jprog)
    jpf = jm.prove(jpk, [jmips.execute(jprog)[1]])
    jside = jmp.compress(jm, jvk, jpf, registry=jmp.build_lift_registry(jm, jvk, jpf.shard_proofs))
    assert int(jside[2].public_values[jmp.RPV_IS_COMPLETE]) == 1

    tprog = tasm.fibonacci_program(8)
    tm = tmips.mips_machine(tconfig.dev_config())
    _tpk, tvk = tm.setup(tprog)
    assert np.array_equal(tvk.commit, jvk.commit)
    shard = carry.shard_proof_from_bytes(jser.serialize_shard_proof(jpf.shard_proofs[0]))
    trm, trvk, _none = tmp.lift_shard(tm, tvk, shard, setup_only=True)
    assert np.array_equal(trvk.commit, jside[1].commit)
    tside = (trm, trvk, carry.shard_proof_from_bytes(jser.serialize_shard_proof(jside[2])))
    return jside, tside, tvk


def test_deferred_leaf_matches_jax(sub_root):
    """The leaf of one claim from the zero digest: the same vk and proof
    bytes from both packages, verified by both, public values [0]*8 + the
    host fold of the claim; compress_bench.instrument times it as one
    deferred_leaf node split as a lift is, and puts every function back."""
    jside, tside, tvk = sub_root
    rpv = [int(v) for v in tside[2].public_values]
    vkey = tD.claim_vk_digest(tvk)
    assert vkey == tD.claim_vk_digest_from_rpv(rpv) == jD.claim_vk_digest_from_rpv(rpv)
    folded = tD.fold_claims([(vkey, rpv[tmp.RPV_DIGEST : tmp.RPV_DIGEST + 32])])

    patched = lambda: (tD.deferred_leaf, tD.deferred_join, tD.attach_deferred, tD._prove_cached)
    before = patched()
    with cb.instrument() as times:
        assert all(a is not b for a, b in zip(patched(), before))
        trm, trvk, tleaf = tD.deferred_leaf(tside, [0] * 8, device="cpu")
    assert patched() == before
    jrm, jrvk, jleaf = jD.deferred_leaf(jside, [0] * 8)

    data = tser.serialize_shard_proof(tleaf)
    assert np.array_equal(trvk.commit, jrvk.commit)
    assert data == jser.serialize_shard_proof(jleaf)
    assert [int(v) for v in tleaf.public_values] == [0] * 8 + folded
    assert trm.verify(trvk, carry.machine_proof_from_shard_bytes(
        [jser.serialize_shard_proof(jleaf)]))
    assert jrm.verify(jrvk, jproof.MachineProof([jser.deserialize_shard_proof(data)]))
    # the leaf's key has one device commit, the CPU's
    _rm, rpk, _rvk, _sig = next(v for v in tpl._SHAPE_CACHE.values() if v[2] is trvk)
    assert [dev for k, dev in tprover.device_keys() if k is rpk] == [torch.device("cpu")]

    assert [len(times.get(k, [])) for k in cb.DEFERRED_NODES] == [1, 0, 0]
    assert set(times) == {"deferred_leaf"}
    leaf = times["deferred_leaf"][0]
    parts = [leaf[k] for k in ("trace_verifier_s", "setup_s", "witness_s", "device_pk_s",
                               "prove_s")]
    assert all(p >= 0 for p in parts) and abs(sum(parts) - leaf["total_s"]) < 1e-6
    assert leaf["trace_verifier_s"] > 0 and leaf["prove_s"] > 0 and leaf["device_pk_s"] > 0
    assert leaf["machine"] == cb.machine_shape(tleaf, trm)
    assert [c[0] for c in leaf["machine"]].count("RecPoseidon2") == 1
