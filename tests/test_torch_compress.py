"""The recursion slice as a whole, small: a dev-config MIPS proof of two
shards (fibonacci(600), shards of 2,048 cycles) is made once by the JAX
package's host prover and carried into the port as bytes; each package then
compresses it (two lifts and a join) and shrinks the root, the port with its
torch shard prover on the CPU, the JAX package with its host prover. Root
and shrink proofs are compared as bytes, the registry roots as words, and
each package's verify_compressed takes the other's root proof. The port's
compress commits each key it proves under once on the device.

In the default profile both packages compress under their own lift-only
registry (mips_pipeline.build_lift_registry). The default registry, the full
lift + join enumeration, traces 170 joins without proving and takes each
package about two minutes more: that case is marked slow."""

import os

import numpy as np
import pytest
import torch

import ziren_tpu.executor.asm as jasm
import ziren_tpu.machine.mips as jmips
import ziren_tpu.recursion.mips_pipeline as jmp
import ziren_tpu.recursion.pipeline as jpl
import ziren_tpu.stark.proof as jproof
import ziren_tpu.stark.serialize as jser
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.recursion.mips_pipeline as tmp
import ziren_tpu_torch.recursion.pipeline as tpl
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.proof as tproof
import ziren_tpu_torch.stark.serialize as tser
import ziren_tpu_torch.stark.verifier as tverifier
from chip_smoke import device_commits
from ziren_tpu_torch.stark import carry, tprover

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def two_shard():
    jprog = jasm.fibonacci_program(600)
    jm, _jpk, jvk, jpf, _ex = jmips.prove_program(jprog, shard_size=2048)
    assert len(jpf.shard_proofs) == 2
    shard_bytes = [jser.serialize_shard_proof(sp) for sp in jpf.shard_proofs]
    tprog = tasm.fibonacci_program(600)
    tm = tmips.mips_machine(tconfig.dev_config())
    _tpk, tvk = tm.setup(tprog, extra_observations=[tprog.pc_start])  # as prove_program does
    assert np.array_equal(tvk.commit, jvk.commit)
    tpf = carry.machine_proof_from_shard_bytes(shard_bytes)
    return (jprog, jm, jvk, jpf), (tprog, tm, tvk, tpf)


def _compress_both(two_shard, jregistry, tregistry):
    """Compress and shrink in both packages; hold root, registry root and
    shrink proof equal; each package verifies the other's root."""
    (jprog, jm, jvk, jpf), (tprog, tm, tvk, tpf) = two_shard
    jrm, jrvk, jroot = jmp.compress(jm, jvk, jpf, registry=jregistry)
    with device_commits() as (keys, commits):
        trm, trvk, troot = tmp.compress(tm, tvk, tpf, registry=tregistry, device="cpu")
    # the bounded table of device keys (stark/tprover.py) evicts no key the
    # tree still proves under: each is committed on the device once, as when
    # every key kept its own commit, beside a main, a permutation and a
    # quotient commit for each of the two lifts and the join
    assert len(keys) <= tprover._DEVICE_KEYS_MAX
    assert len(commits) == 3 * 3 + len(keys)
    data = tser.serialize_shard_proof(troot)
    assert data == jser.serialize_shard_proof(jroot)
    assert np.array_equal(trvk.commit, jrvk.commit)

    rpv = [int(v) for v in troot.public_values]
    assert rpv[tmp.RPV_IS_COMPLETE] == 1 and rpv[tmp.RPV_NEXT_SHARD] == 3
    root_words = rpv[tmp.RPV_VK_ROOT : tmp.RPV_VK_ROOT + 8]
    if tregistry is not None:
        assert root_words == [int(v) for v in tregistry.root] == [int(v) for v in jregistry.root]
    # each package's verifier takes the other's bytes
    from_jax = carry.shard_proof_from_bytes(jser.serialize_shard_proof(jroot))
    digest = tmp.verify_compressed(tm, tvk, trm, trvk, from_jax, pc_start=tprog.pc_start,
                                   vk_root=root_words)
    assert digest == jmp.verify_compressed(jm, jvk, jrm, jrvk, jser.deserialize_shard_proof(data),
                                           pc_start=jprog.pc_start, vk_root=root_words)
    bad_root = [root_words[0] ^ 1] + root_words[1:]
    with pytest.raises(tverifier.VerificationError, match="allowed-vk root"):
        tmp.verify_compressed(tm, tvk, trm, trvk, troot, pc_start=tprog.pc_start,
                              vk_root=bad_root)

    jsm, jsvk, jspf, _ = jpl.shrink(jrm, jrvk, jroot)
    tsm, tsvk, tspf, _ = tpl.shrink(trm, trvk, troot, device="cpu")
    sdata = tser.serialize_shard_proof(tspf.shard_proofs[0])
    assert sdata == jser.serialize_shard_proof(jspf.shard_proofs[0])
    assert np.array_equal(tsvk.commit, jsvk.commit)
    assert tsm.verify(tsvk, tspf)
    assert jsm.verify(jsvk, jproof.MachineProof([jser.deserialize_shard_proof(sdata)]))
    assert [int(v) for v in tspf.shard_proofs[0].public_values] == tpl.lift_digest(trvk, troot)
    return (jrm, jrvk), (trm, trvk, troot)


def test_compress_and_shrink_match_jax(two_shard):
    (_jprog, jm, jvk, jpf), (tprog, tm, tvk, tpf) = two_shard
    jregistry = jmp.build_lift_registry(jm, jvk, jpf.shard_proofs)
    tregistry = tmp.build_lift_registry(tm, tvk, tpf.shard_proofs)
    assert np.array_equal(tregistry.root, jregistry.root)
    _jax, (trm, trvk, troot) = _compress_both(two_shard, jregistry, tregistry)
    # the root join's vk is no member of a lift-only registry
    with pytest.raises(tverifier.VerificationError, match="not in the allowed-vk"):
        tmp.verify_compressed(tm, tvk, trm, trvk, troot, pc_start=tprog.pc_start,
                              registry=tregistry)
    # a partial range is a valid proof that does not attest the execution
    part = tproof.MachineProof(tpf.shard_proofs[:1])
    prm, prvk, psp = tmp.compress(tm, tvk, part, registry=tregistry, device="cpu")
    assert prm.verify(prvk, tproof.MachineProof([psp]))
    assert int(psp.public_values[tmp.RPV_IS_COMPLETE]) == 0
    with pytest.raises(tverifier.VerificationError, match="incomplete"):
        tmp.verify_compressed(tm, tvk, prm, prvk, psp, pc_start=tprog.pc_start)


@pytest.mark.slow
def test_compress_under_the_full_registry_matches_jax(two_shard, tmp_path, monkeypatch):
    """compress as a caller leaves it: each package enumerates its own full
    lift + join registry; the root's vk is a member in both."""
    monkeypatch.setenv("ZIREN_VK_MAP_DIR", str(tmp_path))
    (_jprog, jm, jvk, jpf), (tprog, tm, tvk, tpf) = two_shard
    (jrm, jrvk), (trm, trvk, troot) = _compress_both(two_shard, None, None)
    from ziren_tpu.recursion.shape_universe import build_full_registry as jfull
    from ziren_tpu_torch.recursion.shape_universe import build_full_registry as tfull

    shapes = [tuple(zip(sp.chip_names, (v.log_degree for v in sp.opened_values)))
              for sp in tpf.shard_proofs]
    treg, _depth = tfull(tm, tvk, shapes)
    jreg, _depth = jfull(jm, jvk, shapes)
    assert np.array_equal(treg.root, jreg.root)
    assert len(os.listdir(tmp_path)) == 2  # one cached enumeration a package
    tmp.verify_compressed(tm, tvk, trm, trvk, troot, pc_start=tprog.pc_start, registry=treg)
    jreg.membership(jrvk.commit)
