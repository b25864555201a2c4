"""Deferred proofs: discharge VERIFY_ZKM_PROOF claims inside the tree.

A guest calls VERIFY_ZKM_PROOF(vkey_digest, pv_digest) per sub-proof and
commits the running fold

    digest' = poseidon2_hash(digest ++ vkey_digest ++ pv_digest_bytes)

as pv.deferred_proofs_digest (reference: crates/primitives/src/lib.rs:1140
hash_deferred_proof, zkvm/lib/src/verify.rs). The prover must show that
every claim is backed by a real proof. This module builds that evidence:

  * `deferred_leaf` — one recursion proof that (in-circuit) verifies a
    sub-program's COMPRESSED proof (its root recursion proof), checks
    is_complete=1, recomputes the claim's vkey digest from the sub-proof's
    own RPV (poseidon2(vk_commit ++ pc_start)), and folds the claim into
    the reconstruct chain: pv = [start_digest(8), end_digest(8)].
  * `deferred_chain` — leaves chained pairwise (end_i == start_{i+1}) down
    to ONE proof covering all claims: [0..0] -> final digest.
  * `attach_deferred` — the root merge: verifies the core compress root and
    the deferred chain, asserts the chain starts at zero and ends at the
    digest the core leaves were seeded with, and re-exposes the core RPV
    with START_RECON=0 / END_RECON=chain end so the extended completeness
    rules (mips_pipeline._bind_completeness: claimed deferred digest ==
    reconstructed digest) decide is_complete.

Reference: crates/recursion/circuit/src/machine/deferred.rs,
crates/prover/src/lib.rs:595 (get_first_layer_inputs).
"""

from __future__ import annotations

import numpy as np

from ..core import poseidon2 as p2
from .dsl import Tracer
from .mips_pipeline import (
    RPV_DEFERRED,
    RPV_DIGEST,
    RPV_END_RECON,
    RPV_IS_COMPLETE,
    RPV_PC_START,
    RPV_START_RECON,
    RPV_VK,
    RPV_WIDTH,
    _bind_completeness,
    _rpv_point,
)
from .pipeline import _config_key, _prove_cached, _shape_key
from .verifier import traced_hash_rows, traced_verify_shard

# Deferred-chain public values: [start_digest(8), end_digest(8)]
DPV_START = 0
DPV_END = 8
DPV_WIDTH = 16


def claim_vk_digest(mips_vk) -> list:
    """The 8-felt vkey digest a guest passes to VERIFY_ZKM_PROOF for a
    program with this MIPS vk: poseidon2(vk_commit ++ pc_start)
    (reference: ZKMVerifyingKey::hash_koalabear). Always 9 felts — pc_start
    is 0 for a vk without the entry-point observation — matching the
    in-circuit recomputation from the sub-proof's RPV."""
    extras = [int(x) for x in mips_vk.extra_observations]
    flat = [int(v) for v in mips_vk.commit] + [extras[0] if extras else 0]
    return [int(v) for v in p2.hash_iter(np.asarray(flat, np.uint32))]


def fold_claim(prev8, vkey8, pv_digest32) -> list:
    """hash_deferred_proof (reference primitives/src/lib.rs:1140)."""
    flat = [int(v) for v in prev8] + [int(v) for v in vkey8] + [
        int(v) for v in pv_digest32
    ]
    assert len(flat) == 48
    return [int(v) for v in p2.hash_iter(np.asarray(flat, np.uint32))]


def fold_claims(claims) -> list:
    """Host fold of [(vkey8, pv_digest32)] from zero — the digest the guest
    must have committed as pv.deferred_proofs_digest."""
    digest = [0] * 8
    for vkey8, pv32 in claims:
        digest = fold_claim(digest, vkey8, pv32)
    return digest


def pv_digest_bytes_to_words(pv32) -> list:
    """32 byte-felts -> the 8 u32 LE words a guest passes as pv_digest."""
    return [
        int(pv32[4 * i])
        | (int(pv32[4 * i + 1]) << 8)
        | (int(pv32[4 * i + 2]) << 16)
        | (int(pv32[4 * i + 3]) << 24)
        for i in range(8)
    ]


def deferred_leaf(sub_side, prev_digest, config=None, device=None):
    """One recursion proof folding one sub-proof claim into the chain.

    sub_side: (rec_machine, rec_vk, final_sp) — the sub-program's compress
    root (is_complete must be 1). prev_digest: chain digest before this
    claim. Returns (machine, vk, shard_proof) with DPV public values.
    `device` (here and below) is where the recursion proof is made
    (StarkMachine.prove: None is the GPU, a torch device, or "host"); it is
    resolved first, so that a caller without a card fails before the
    verifier is traced."""
    from ..device import prover_device

    prover_device(device)
    sub_m, sub_vk, sub_sp = sub_side
    sub_rpv = [int(v) for v in sub_sp.public_values]
    assert len(sub_rpv) == RPV_WIDTH, "sub-proof must expose the RPV layout"
    vkey = claim_vk_digest_from_rpv(sub_rpv)
    end = fold_claim(prev_digest, vkey, sub_rpv[RPV_DIGEST : RPV_DIGEST + 32])
    dpv = [int(v) for v in prev_digest] + end

    t = Tracer(num_inputs=DPV_WIDTH, input_values=dpv)
    dp = [t.input(i) for i in range(DPV_WIDTH)]
    rpv_h = [t.hint(v) for v in sub_rpv]
    vk_consts = [t.const(int(v)) for v in sub_vk.commit]
    traced_verify_shard(t, sub_m, sub_vk, sub_sp, rpv_h, vk_consts)
    one = t.const(1)
    t.assert_eq(rpv_h[RPV_IS_COMPLETE], one)

    # vkey digest recomputed from the verified sub-RPV
    vkey_h = traced_hash_rows(
        t, rpv_h[RPV_VK : RPV_VK + 8] + [rpv_h[RPV_PC_START]]
    )
    folded = traced_hash_rows(
        t,
        dp[DPV_START : DPV_START + 8]
        + vkey_h
        + rpv_h[RPV_DIGEST : RPV_DIGEST + 32],
    )
    for i in range(8):
        t.assert_eq(dp[DPV_END + i], folded[i])

    prog = t.program()
    key = (("dleaf",) + _config_key(config)
           + _shape_key(sub_m, sub_sp, sub_vk))
    rm, rvk, rproof = _prove_cached(key, prog, dpv, t.hint_values, config,
                                    tracer=t, device=device)
    return rm, rvk, rproof.shard_proofs[0]


def claim_vk_digest_from_rpv(rpv) -> list:
    """vkey digest from a sub-proof's RPV: poseidon2(vk ++ pc_start) — the
    in-circuit form of claim_vk_digest for a 1-extra-observation vk."""
    flat = [int(v) for v in rpv[RPV_VK : RPV_VK + 8]] + [
        int(rpv[RPV_PC_START])
    ]
    return [int(v) for v in p2.hash_iter(np.asarray(flat, np.uint32))]


def deferred_join(side_a, side_b, config=None, device=None):
    """Chain two deferred sub-chains: a.end == b.start."""
    from ..device import prover_device

    prover_device(device)
    (ma, vka, spa), (mb, vkb, spb) = side_a, side_b
    dpv_a = [int(v) for v in spa.public_values]
    dpv_b = [int(v) for v in spb.public_values]
    out = dpv_a[DPV_START : DPV_START + 8] + dpv_b[DPV_END : DPV_END + 8]

    t = Tracer(num_inputs=DPV_WIDTH, input_values=out)
    dp = [t.input(i) for i in range(DPV_WIDTH)]
    a_h = [t.hint(v) for v in dpv_a]
    b_h = [t.hint(v) for v in dpv_b]
    traced_verify_shard(t, ma, vka, spa, a_h,
                        [t.const(int(v)) for v in vka.commit])
    traced_verify_shard(t, mb, vkb, spb, b_h,
                        [t.const(int(v)) for v in vkb.commit])
    for i in range(8):
        t.assert_eq(a_h[DPV_END + i], b_h[DPV_START + i])
        t.assert_eq(dp[DPV_START + i], a_h[DPV_START + i])
        t.assert_eq(dp[DPV_END + i], b_h[DPV_END + i])

    prog = t.program()
    key = (("djoin",) + _config_key(config) + _shape_key(ma, spa, vka)
           + _shape_key(mb, spb, vkb))
    rm, rvk, rproof = _prove_cached(key, prog, out, t.hint_values, config,
                                    tracer=t, device=device)
    return rm, rvk, rproof.shard_proofs[0]


def deferred_chain(sub_sides, config=None, device=None):
    """Fold every sub-proof claim (in guest claim order) into ONE recursion
    proof with pv = [0..0, final_digest]."""
    assert sub_sides, "deferred_chain needs at least one sub-proof"
    digest = [0] * 8
    layer = []
    for side in sub_sides:
        leaf = deferred_leaf(side, digest, config=config, device=device)
        digest = [int(v) for v in leaf[2].public_values[DPV_END:]]
        layer.append(leaf)
    while len(layer) > 1:
        nxt = []
        for i in range(0, len(layer) - 1, 2):
            nxt.append(deferred_join(layer[i], layer[i + 1], config=config,
                                     device=device))
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


def attach_deferred(core_side, deferred_side, config=None, device=None):
    """Root merge: one recursion proof attesting (core compress root +
    deferred chain). Output pv = core RPV with START_RECON := 0,
    END_RECON := chain end, is_complete recomputed — complete iff the
    chain reconstructs exactly the digest the guest claimed."""
    from ..core import septic as S
    from ..device import prover_device
    from .mips_pipeline import _is_complete
    from .septic import host_sum_digest  # noqa: F401  (doc pointer)

    prover_device(device)

    (cm, cvk, csp), (dm, dvk, dsp) = core_side, deferred_side
    core_rpv = [int(v) for v in csp.public_values]
    dpv = [int(v) for v in dsp.public_values]
    assert len(core_rpv) == RPV_WIDTH and len(dpv) == DPV_WIDTH
    out = list(core_rpv)
    out[RPV_START_RECON : RPV_START_RECON + 8] = [0] * 8
    out[RPV_END_RECON : RPV_END_RECON + 8] = dpv[DPV_END : DPV_END + 8]
    out[RPV_IS_COMPLETE] = 1 if _is_complete(out) else 0

    t = Tracer(num_inputs=RPV_WIDTH, input_values=out)
    rpv = [t.input(i) for i in range(RPV_WIDTH)]
    c_h = [t.hint(v) for v in core_rpv]
    d_h = [t.hint(v) for v in dpv]
    traced_verify_shard(t, cm, cvk, csp, c_h,
                        [t.const(int(v)) for v in cvk.commit])
    traced_verify_shard(t, dm, dvk, dsp, d_h,
                        [t.const(int(v)) for v in dvk.commit])
    zero = t.const(0)
    for i in range(8):
        # chain starts at zero and lands on the seed the core tree carried
        t.assert_eq(d_h[DPV_START + i], zero)
        t.assert_eq(d_h[DPV_END + i], c_h[RPV_START_RECON + i])
        t.assert_eq(rpv[RPV_START_RECON + i], zero)
        t.assert_eq(rpv[RPV_END_RECON + i], d_h[DPV_END + i])
    # every other RPV field passes through unchanged (incl. the vk-registry
    # root beyond the recon digests)
    from .mips_pipeline import RPV_VK_ROOT

    passthrough = list(range(RPV_START_RECON)) + list(
        range(RPV_VK_ROOT, RPV_VK_ROOT + 8)
    )
    for i in passthrough:
        if i == RPV_IS_COMPLETE:
            continue
        t.assert_eq(rpv[i], c_h[i])
    # core node must not have claimed completeness itself
    t.assert_eq(c_h[RPV_IS_COMPLETE], zero)
    from .mips_pipeline import RPV_GLOBAL_SUM

    dig = _rpv_point(rpv[RPV_GLOBAL_SUM : RPV_GLOBAL_SUM + 14])
    _bind_completeness(t, rpv, dig)

    prog = t.program()
    key = (("dattach",) + _config_key(config) + _shape_key(cm, csp, cvk)
           + _shape_key(dm, dsp, dvk))
    rm, rvk, rproof = _prove_cached(key, prog, out, t.hint_values, config,
                                    tracer=t, device=device)
    return rm, rvk, rproof.shard_proofs[0]
