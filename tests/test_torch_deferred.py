"""Proof composition (recursion/deferred.py) in the port against the JAX
package, on the CPU, tolerance 0: digests are compared as words, proofs as
bytes.

A guest claims another zkVM proof with VERIFY_ZKM_PROOF and commits the
fold of its claims with COMMIT_DEFERRED_PROOFS; the recursion tree proves
every claim with a deferred leaf, chains the leaves with joins, and merges
the chain into the guest's compressed root (attach_deferred), which is only
complete when the chain lands on the committed fold.

In the default profile: the host digests of the claims, the claim guests
(one claim and two, built from each package's asm primitives by
tools/claim_programs.py) executed and proved in both packages, the SDK's
refusals of sub-proofs that do not back the claims, and that every entry
point of the path needs the GPU unless told otherwise. The deferred leaf
alone is held in tests/test_torch_deferred_leaf.py. The whole composition in
both packages, one claim and two (the attach, and the deferred join of two
leaves), is marked slow, as the JAX package's tests/test_deferred.py is."""

import os
import types

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
import ziren_tpu_torch.sdk as tsdk
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.serialize as tser
from ziren_tpu_torch.stark import carry
from ziren_tpu_torch.stark.verifier import VerificationError
from ziren_tpu_torch.tools import compress_bench as cb
from ziren_tpu_torch.tools.claim_programs import claims_program, digest_bytes

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

P = 2130706433


def _felts(rng, n):
    return [int(v) for v in rng.integers(0, P, n)]


def _bytes(rng, n):
    return [int(v) for v in rng.integers(0, 256, n)]


def _vk(rng, entry):
    return types.SimpleNamespace(commit=np.asarray(_felts(rng, 8), np.uint32),
                                 extra_observations=[entry] if entry is not None else [])


# each digest function of the module on seeded inputs: (name, args from a rng)
DIGESTS = {
    "claim_vk_digest": lambda rng: (_vk(rng, int(rng.integers(0, 1 << 20)) * 4),),
    "claim_vk_digest without an entry": lambda rng: (_vk(rng, None),),
    "fold_claim": lambda rng: (_felts(rng, 8), _felts(rng, 8), _bytes(rng, 32)),
    "fold_claims": lambda rng: ([(_felts(rng, 8), _bytes(rng, 32))
                                 for _ in range(int(rng.integers(0, 4)))],),
    "pv_digest_bytes_to_words": lambda rng: (_bytes(rng, 32),),
    "claim_vk_digest_from_rpv": lambda rng: (_felts(rng, tmp.RPV_WIDTH),),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_claim_digests_match_jax(name, seed):
    args = DIGESTS[name](np.random.default_rng([seed, len(name)]))
    fn = name.split(" ")[0]
    got, want = getattr(tD, fn)(*args), getattr(jD, fn)(*args)
    assert got == want and all(isinstance(v, int) for v in got)
    assert len(got) == 8
    if fn == "pv_digest_bytes_to_words":
        assert digest_bytes(got) == args[0]


def _claims(seed, n):
    """n seeded claims (vkey digest, pv digest words) and their fold."""
    rng = np.random.default_rng(seed)
    claims = [(_felts(rng, 8), [int(w) for w in rng.integers(0, 1 << 32, 8, dtype=np.uint64)])
              for _ in range(n)]
    return claims, tD.fold_claims([(v, digest_bytes(w)) for v, w in claims])


def _guest(asm, claims, folded):
    if len(claims) == 1:  # one claim: the package's own deferred_claim_program, word for word
        program = asm.deferred_claim_program(*claims[0], folded)
        assert claims_program(asm, claims, folded).instructions == program.instructions
        return program
    return claims_program(asm, claims, folded)


@pytest.mark.parametrize("n", [1, 2])
def test_claim_guest_matches_jax(n):
    """The guest executes to the same claims and deferred digest in both
    packages; the port's dev-config proof of its shard is the JAX host
    prover's, byte for byte, and each verifier takes the other's bytes."""
    claims, folded = _claims(10 + n, n)
    assert folded == jD.fold_claims([(v, digest_bytes(w)) for v, w in claims])
    jprog, tprog = _guest(jasm, claims, folded), _guest(tasm, claims, folded)
    _jex, jrec = jmips.execute(jprog)
    _tex, trec = tmips.execute(tprog)
    want = [(tuple(v), tuple(w)) for v, w in claims]
    assert jrec.deferred_proof_claims == trec.deferred_proof_claims == want
    assert list(jrec.public_values.deferred_proofs_digest) == folded
    assert list(trec.public_values.deferred_proofs_digest) == folded
    assert trec.public_values.to_list() == jrec.public_values.to_list()

    jm, tm = jmips.mips_machine(jconfig.dev_config()), tmips.mips_machine(tconfig.dev_config())
    jpk, jvk = jm.setup(jprog)
    tpk, tvk = tm.setup(tprog)
    assert np.array_equal(tvk.commit, jvk.commit)
    jpf = jm.prove(jpk, [jrec])
    tpf = tm.prove(tpk, [trec], device="cpu")
    data = tser.serialize_shard_proof(tpf.shard_proofs[0])
    assert data == jser.serialize_shard_proof(jpf.shard_proofs[0])
    assert tmips.verify_mips_proof(tm, tvk, carry.machine_proof_from_shard_bytes(
        [jser.serialize_shard_proof(jpf.shard_proofs[0])]), pc_start=tprog.pc_start)
    assert jmips.verify_mips_proof(jm, jvk, jproof.MachineProof([jser.deserialize_shard_proof(data)]),
                                   pc_start=jprog.pc_start)


def _sub_side(rng):
    """A stand-in for a compressed sub-proof: only its public values (an RPV
    with a seeded vk, entry and digest) are read before any recursion."""
    rpv = [0] * tmp.RPV_WIDTH
    rpv[tmp.RPV_VK : tmp.RPV_VK + 8] = _felts(rng, 8)
    rpv[tmp.RPV_PC_START] = _felts(rng, 1)[0]
    rpv[tmp.RPV_DIGEST : tmp.RPV_DIGEST + 32] = _bytes(rng, 32)
    rpv[tmp.RPV_IS_COMPLETE] = 1
    return (None, None, types.SimpleNamespace(public_values=rpv))


def _claim_of(side):
    rpv = side[2].public_values
    return (tD.claim_vk_digest_from_rpv(rpv),
            tD.pv_digest_bytes_to_words(rpv[tmp.RPV_DIGEST : tmp.RPV_DIGEST + 32]))


@pytest.fixture(scope="module")
def two_claims():
    """A guest that claims two seeded sub-proofs, and its core proof through
    the SDK (device="cpu"), made once."""
    rng = np.random.default_rng(7)
    a, b = _sub_side(rng), _sub_side(rng)
    claims = [_claim_of(a), _claim_of(b)]
    folded = tD.fold_claims([(v, digest_bytes(w)) for v, w in claims])
    client = tsdk.ProverClient(config="dev", device="cpu")
    pk, _vk = client.setup(claims_program(tasm, claims, folded))
    core = client.prove(pk)
    assert [r.deferred_proof_claims for r in core._records][0] == [
        (tuple(v), tuple(w)) for v, w in claims]
    return client, pk, core, a, b, folded


class _Reached(Exception):
    pass


def _other_digest(side):
    rpv = list(side[2].public_values)
    rpv[tmp.RPV_DIGEST] ^= 1
    return (None, None, types.SimpleNamespace(public_values=rpv))


# (the sub-proofs handed over for the guest's two claims, what is raised)
REFUSALS = {
    "one sub-proof for two claims": (lambda a, b: [a], "2 proof claims but 1"),
    "another vk": (lambda a, b: [b, a], "vkey does not match"),
    "another public-values digest": (lambda a, b: [a, _other_digest(b)],
                                     "pv digest does not match"),
    "no sub-proof": (lambda a, b: [], "2 proof claims but 0"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS) + ["the claims' own sub-proofs"])
def test_compressed_prove_refuses_unbacked_claims(two_claims, case, monkeypatch):
    """ProverClient.compressed_prove checks every claim against its
    sub-proof (count, vk digest, public-values digest) after the core prove
    and before any recursion proof; claims that are backed reach compress
    seeded with their fold."""
    client, pk, core, a, b, folded = two_claims
    monkeypatch.setattr(client, "prove", lambda *args, **kw: core)

    def compress(machine, vk, proof, config=None, reconstruct_digest=None, **kw):
        assert reconstruct_digest == folded
        raise _Reached

    def no_recursion(*args, **kw):
        raise AssertionError("a deferred node ran")

    monkeypatch.setattr(tmp, "compress", compress)
    for name in cb.DEFERRED_NODES + ("deferred_chain",):
        monkeypatch.setattr(tD, name, no_recursion)
    if case in REFUSALS:
        sides, message = REFUSALS[case]
        with pytest.raises(VerificationError, match=message):
            client.compressed_prove(pk, deferred=sides(a, b))
    else:
        with pytest.raises(_Reached):
            client.compressed_prove(pk, deferred=[a, b])


NEEDS_THE_GPU = ["ProverClient.compressed_prove", "deferred_leaf", "deferred_join",
                 "deferred_chain", "attach_deferred"]


@pytest.mark.parametrize("entry", NEEDS_THE_GPU)
def test_composition_without_a_device_needs_the_gpu(entry):
    """`device` left out is the GPU in every entry point of the composition
    path: without one they raise, before any proof or traced verifier, and
    never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    side = (None, None, None)

    def compressed_prove():
        claims, folded = _claims(3, 1)
        client = tsdk.ProverClient(config="dev")
        pk, _vk = client.setup(claims_program(tasm, claims, folded))
        return client.compressed_prove(pk, deferred=[side])

    calls = {
        "ProverClient.compressed_prove": compressed_prove,
        "deferred_leaf": lambda: tD.deferred_leaf(side, [0] * 8),
        "deferred_join": lambda: tD.deferred_join(side, side),
        "deferred_chain": lambda: tD.deferred_chain([side, side]),
        "attach_deferred": lambda: tD.attach_deferred(side, side),
    }
    assert sorted(calls) == sorted(NEEDS_THE_GPU)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def _recorded(module, names, log, monkeypatch):
    """Record every call's result of module.<name> in log[name]."""
    for name in names:
        fn = getattr(module, name)

        def wrapper(*args, _fn=fn, _name=name, **kw):
            out = _fn(*args, **kw)
            log.setdefault(_name, []).append(out)
            return out

        monkeypatch.setattr(module, name, wrapper)


def _same(tside, jside):
    """A recursion node of the port equals the JAX package's: vk and proof
    bytes."""
    assert np.array_equal(tside[1].commit, jside[1].commit)
    data = tser.serialize_shard_proof(tside[2])
    assert data == jser.serialize_shard_proof(jside[2])
    return data


@pytest.mark.slow
@pytest.mark.parametrize("n", [1, 2])
def test_composition_matches_jax(n, monkeypatch):
    """The whole composition at the dev config, in both packages, each under
    its own lift-only registries: fibonacci(8) proved and compressed to a
    complete root; a guest that claims it n times, proved and compressed
    seeded with the fold (not complete alone); the deferred chain (n leaves,
    n - 1 joins); the attach, complete. Every proof and node is byte-equal
    across the packages and each verify_compressed takes the other's root.
    The port's nodes are timed by compress_bench.instrument."""
    jm, tm = jmips.mips_machine(jconfig.dev_config()), tmips.mips_machine(tconfig.dev_config())

    def both(jprog, tprog, reconstruct=None):
        """Prove one program in both packages, byte-equal; compress each."""
        jpk, jvk = jm.setup(jprog)
        tpk, tvk = tm.setup(tprog)
        jrecs, trecs = [jmips.execute(jprog)[1]], [tmips.execute(tprog)[1]]
        jpf, tpf = jm.prove(jpk, jrecs), tm.prove(tpk, trecs, device="cpu")
        assert (tser.serialize_shard_proof(tpf.shard_proofs[0])
                == jser.serialize_shard_proof(jpf.shard_proofs[0]))
        jreg = jmp.build_lift_registry(jm, jvk, jpf.shard_proofs)
        treg = tmp.build_lift_registry(tm, tvk, tpf.shard_proofs)
        jside = jmp.compress(jm, jvk, jpf, reconstruct_digest=reconstruct, registry=jreg)
        tside = tmp.compress(tm, tvk, tpf, reconstruct_digest=reconstruct, registry=treg,
                             device="cpu")
        _same(tside, jside)
        return (jvk, jrecs, jside), (tvk, trecs, tside)

    (jsvk, _j, jsub), (tsvk, _t, tsub) = both(jasm.fibonacci_program(8),
                                              tasm.fibonacci_program(8))
    rpv = [int(v) for v in tsub[2].public_values]
    assert rpv[tmp.RPV_IS_COMPLETE] == 1
    vkey = tD.claim_vk_digest(tsvk)
    assert vkey == jD.claim_vk_digest(jsvk) == tD.claim_vk_digest_from_rpv(rpv)
    pv32 = rpv[tmp.RPV_DIGEST : tmp.RPV_DIGEST + 32]
    claims = [(vkey, tD.pv_digest_bytes_to_words(pv32))] * n
    folded = tD.fold_claims([(vkey, pv32)] * n)
    (jmvk, jrecs, jcore), (tmvk, trecs, tcore) = both(
        _guest(jasm, claims, folded), _guest(tasm, claims, folded), reconstruct=folded)
    assert trecs[0].deferred_proof_claims == jrecs[0].deferred_proof_claims
    assert int(tcore[2].public_values[tmp.RPV_IS_COMPLETE]) == 0
    with pytest.raises(VerificationError, match="incomplete"):
        tmp.verify_compressed(tm, tmvk, *tcore)

    jlog, tlog = {}, {}
    _recorded(jD, ("deferred_leaf", "deferred_join"), jlog, monkeypatch)
    _recorded(tD, ("deferred_leaf", "deferred_join"), tlog, monkeypatch)
    with cb.instrument() as times:
        tchain = tD.deferred_chain([tsub] * n, device="cpu")
        troot = tD.attach_deferred(tcore, tchain, device="cpu")
    jchain = jD.deferred_chain([jsub] * n)
    jroot = jD.attach_deferred(jcore, jchain)
    assert [len(tlog.get(k, [])) for k in ("deferred_leaf", "deferred_join")] == [n, n - 1]
    for kind in ("deferred_leaf", "deferred_join"):
        assert len(tlog.get(kind, [])) == len(jlog.get(kind, []))
        for t, j in zip(tlog.get(kind, []), jlog.get(kind, [])):
            _same(t, j)
    assert [int(v) for v in tchain[2].public_values] == [0] * 8 + folded
    data = _same(troot, jroot)
    assert [len(times.get(k, [])) for k in cb.DEFERRED_NODES] == [n, n - 1, 1]

    assert int(troot[2].public_values[tmp.RPV_IS_COMPLETE]) == 1
    digest = tmp.verify_compressed(tm, tmvk, troot[0], troot[1],
                                   carry.shard_proof_from_bytes(
                                       jser.serialize_shard_proof(jroot[2])))
    assert digest == jmp.verify_compressed(jm, jmvk, jroot[0], jroot[1],
                                           jser.deserialize_shard_proof(data))
    assert isinstance(digest, bytes) and len(digest) == 32
