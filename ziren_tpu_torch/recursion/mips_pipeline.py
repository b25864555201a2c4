"""MIPS recursion pipeline with canonical RecursionPublicValues.

Every recursion proof in the MIPS compress tree — lift or join — exposes
the SAME fixed-width public-value summary (the reference's
RecursionPublicValues, crates/recursion/core/src/air/public_values.rs):
the inner machine vk, the committed/deferred digests, the pc/shard
boundary state, the memory init/finalize address-bit chain endpoints, the
accumulated septic global cumulative sum, and an `is_complete` flag.

Soundness properties enforced IN-CIRCUIT at every tree layer (this fixes
the round-1 gap where only first-layer pairs were chained and the septic
sums were dropped):

  * lift: the shard proof's full public values enter as hints, verified by
    the traced shard verifier, and every summary field is bound to them;
    the shard's septic digest is accumulated from the (constraint-bound)
    per-chip global cumulative sums.
  * join: both children are verified in-circuit (their recursion vks are
    pinned as constants), adjacent boundaries are chained (pc, shard
    index, execution shard, init/finalize addr bits), the committed and
    deferred digests are asserted equal across children, and the septic
    global sums are added on the curve (recursion/septic.py).
  * is_complete: when set, the proof attests a COMPLETE execution —
    first shard is 1, start_pc is the program entry, the program halted
    with exit code 0, and the accumulated septic digest is the zero
    digest (cross-shard memory consistency).

Reference: crates/recursion/circuit/src/machine/core.rs (lift),
machine/compress.rs (join + digest accumulation),
crates/prover/src/verify.rs (host-side root checks).
"""

from __future__ import annotations

import numpy as np

from ..core import septic as S
from ..machine.messages import (
    PV_DEFERRED,
    PV_DIGEST,
    PV_EXECUTION_SHARD,
    PV_EXIT_CODE,
    PV_NEXT_PC,
    PV_SHARD,
    PV_START_PC,
)
from .dsl import Tracer
from .pipeline import _prove_cached, _shape_key
from .septic import (
    assert_digest_zero,
    host_sum_digest,
    traced_sum_digest,
)
from .verifier import traced_verify_shard

# Shard pv layout beyond the named indices (executor/record.py to_list):
PV_PREV_INIT_ADDR = 45  # 32 bits
PV_LAST_INIT_ADDR = 77
PV_PREV_FIN_ADDR = 109
PV_LAST_FIN_ADDR = 141
PV_PADDING = 173  # zero through 231

# RecursionPublicValues layout (fixed width for every lift/join)
RPV_VK = 0  # 8: inner MIPS machine vk commit
RPV_DIGEST = 8  # 32: committed_value_digest byte felts
RPV_DEFERRED = 40  # 8: deferred_proofs_digest
RPV_START_PC = 48
RPV_NEXT_PC = 49
RPV_START_SHARD = 50
RPV_NEXT_SHARD = 51
RPV_START_EXEC_SHARD = 52
RPV_NEXT_EXEC_SHARD = 53
RPV_PREV_INIT_ADDR = 54  # 32
RPV_LAST_INIT_ADDR = 86  # 32
RPV_PREV_FIN_ADDR = 118  # 32
RPV_LAST_FIN_ADDR = 150  # 32
RPV_EXIT_CODE = 182
RPV_GLOBAL_SUM = 183  # 14: septic digest (x0..x6, y0..y6)
RPV_IS_COMPLETE = 197
RPV_PC_START = 198  # program entry (the MIPS vk's extra observation)
RPV_START_RECON = 199  # 8: deferred reconstruct digest at the range start
RPV_END_RECON = 207  # 8: deferred reconstruct digest at the range end
RPV_VK_ROOT = 215  # 8: allowed-vk registry Merkle root (zeros = unpinned)
RPV_WIDTH = 223


def shard_global_digest(machine, shard_proof):
    """Host septic digest of one shard: digest-form sum of the per-chip
    global cumulative sums carried in the proof's opened values."""
    points = []
    for name, vals in zip(shard_proof.chip_names, shard_proof.opened_values):
        if machine.chip_by_name[name].commit_scope.name == "Global":
            g = np.asarray(vals.global_cumulative_sum, np.uint32)
            points.append((g[:7], g[7:14]))
    return host_sum_digest(points)


def _is_complete(rpv) -> bool:
    gx = np.asarray(rpv[RPV_GLOBAL_SUM : RPV_GLOBAL_SUM + 7], np.uint32)
    gy = np.asarray(rpv[RPV_GLOBAL_SUM + 7 : RPV_GLOBAL_SUM + 14], np.uint32)
    return (
        rpv[RPV_START_SHARD] == 1
        and rpv[RPV_NEXT_PC] == 0
        and rpv[RPV_EXIT_CODE] == 0
        and rpv[RPV_START_PC] == rpv[RPV_PC_START]
        # the memory address chains anchor at zero (bootstrap), so the
        # per-shard strict orderings compose into one global ordering
        and all(v == 0 for v in rpv[RPV_PREV_INIT_ADDR : RPV_PREV_INIT_ADDR + 32])
        and all(v == 0 for v in rpv[RPV_PREV_FIN_ADDR : RPV_PREV_FIN_ADDR + 32])
        and S.digest_is_zero((gx, gy))
        # every VERIFY_ZKM_PROOF claim is discharged: the deferred chain
        # starts at zero and reconstructs the claimed digest
        and list(rpv[RPV_START_RECON : RPV_START_RECON + 8]) == [0] * 8
        and list(rpv[RPV_END_RECON : RPV_END_RECON + 8])
        == list(rpv[RPV_DEFERRED : RPV_DEFERRED + 8])
    )


def shard_rpv(machine, vk, shard_proof, reconstruct_digest=None,
              vk_root=None) -> list:
    """Host-side RecursionPublicValues for one MIPS shard proof.

    reconstruct_digest: the deferred-chain digest this core range sits on
    (core leaves do not advance the chain: start == end). Zeros when the
    guest made no VERIFY_ZKM_PROOF claims.

    vk_root: the allowed-vk registry Merkle root this tree runs under
    (recursion/vk_registry.py). Lifts only CARRY it; joins verify their
    leaf children's recursion vks against it in-circuit (reference
    prover/src/shapes.rs vk_map + machine/compress.rs vk Merkle proofs)."""
    pv = [int(v) for v in shard_proof.public_values]
    dig = shard_global_digest(machine, shard_proof)
    extras = [int(x) for x in vk.extra_observations]
    assert len(extras) <= 1, "RPV carries at most one vk extra observation"
    rpv = [0] * RPV_WIDTH
    rpv[RPV_VK : RPV_VK + 8] = [int(v) for v in vk.commit]
    rpv[RPV_DIGEST : RPV_DIGEST + 32] = pv[PV_DIGEST : PV_DIGEST + 32]
    rpv[RPV_DEFERRED : RPV_DEFERRED + 8] = pv[PV_DEFERRED : PV_DEFERRED + 8]
    rpv[RPV_START_PC] = pv[PV_START_PC]
    rpv[RPV_NEXT_PC] = pv[PV_NEXT_PC]
    rpv[RPV_START_SHARD] = pv[PV_SHARD]
    rpv[RPV_NEXT_SHARD] = pv[PV_SHARD] + 1
    # the execution-shard counter advances only across Cpu shards
    # (standalone memory shards from deferred splitting carry it unchanged)
    has_cpu = "Cpu" in shard_proof.chip_names
    rpv[RPV_START_EXEC_SHARD] = pv[PV_EXECUTION_SHARD]
    rpv[RPV_NEXT_EXEC_SHARD] = pv[PV_EXECUTION_SHARD] + (1 if has_cpu else 0)
    rpv[RPV_PREV_INIT_ADDR : RPV_PREV_INIT_ADDR + 32] = pv[
        PV_PREV_INIT_ADDR : PV_PREV_INIT_ADDR + 32
    ]
    rpv[RPV_LAST_INIT_ADDR : RPV_LAST_INIT_ADDR + 32] = pv[
        PV_LAST_INIT_ADDR : PV_LAST_INIT_ADDR + 32
    ]
    rpv[RPV_PREV_FIN_ADDR : RPV_PREV_FIN_ADDR + 32] = pv[
        PV_PREV_FIN_ADDR : PV_PREV_FIN_ADDR + 32
    ]
    rpv[RPV_LAST_FIN_ADDR : RPV_LAST_FIN_ADDR + 32] = pv[
        PV_LAST_FIN_ADDR : PV_LAST_FIN_ADDR + 32
    ]
    rpv[RPV_EXIT_CODE] = pv[PV_EXIT_CODE]
    rpv[RPV_GLOBAL_SUM : RPV_GLOBAL_SUM + 7] = [int(v) for v in dig[0]]
    rpv[RPV_GLOBAL_SUM + 7 : RPV_GLOBAL_SUM + 14] = [int(v) for v in dig[1]]
    rpv[RPV_PC_START] = extras[0] if extras else 0
    rd = [int(v) for v in (reconstruct_digest or [0] * 8)]
    rpv[RPV_START_RECON : RPV_START_RECON + 8] = rd
    rpv[RPV_END_RECON : RPV_END_RECON + 8] = rd
    rpv[RPV_VK_ROOT : RPV_VK_ROOT + 8] = [
        int(v) for v in (vk_root if vk_root is not None else [0] * 8)
    ]
    rpv[RPV_IS_COMPLETE] = 1 if _is_complete(rpv) else 0
    return rpv


def combine_rpv(rpv_a: list, rpv_b: list) -> list:
    """Host-side parent RPV of two adjacent children (mirrors the join's
    in-circuit combination exactly)."""
    out = [0] * RPV_WIDTH
    assert rpv_a[RPV_VK : RPV_VK + 8] == rpv_b[RPV_VK : RPV_VK + 8]
    assert (
        rpv_a[RPV_VK_ROOT : RPV_VK_ROOT + 8]
        == rpv_b[RPV_VK_ROOT : RPV_VK_ROOT + 8]
    ), "vk-registry root mismatch between children"
    assert rpv_a[RPV_DIGEST : RPV_DEFERRED + 8] == rpv_b[RPV_DIGEST : RPV_DEFERRED + 8]
    assert rpv_a[RPV_NEXT_PC] == rpv_b[RPV_START_PC], "pc chain broken"
    assert rpv_a[RPV_NEXT_SHARD] == rpv_b[RPV_START_SHARD], "shard chain broken"
    assert rpv_a[RPV_NEXT_EXEC_SHARD] == rpv_b[RPV_START_EXEC_SHARD]
    assert (
        rpv_a[RPV_LAST_INIT_ADDR : RPV_LAST_INIT_ADDR + 32]
        == rpv_b[RPV_PREV_INIT_ADDR : RPV_PREV_INIT_ADDR + 32]
    ), "init addr-bit chain broken"
    assert (
        rpv_a[RPV_LAST_FIN_ADDR : RPV_LAST_FIN_ADDR + 32]
        == rpv_b[RPV_PREV_FIN_ADDR : RPV_PREV_FIN_ADDR + 32]
    ), "finalize addr-bit chain broken"
    assert rpv_a[RPV_PC_START] == rpv_b[RPV_PC_START]
    assert (
        rpv_a[RPV_END_RECON : RPV_END_RECON + 8]
        == rpv_b[RPV_START_RECON : RPV_START_RECON + 8]
    ), "deferred reconstruct chain broken"
    out[RPV_VK : RPV_DEFERRED + 8] = rpv_a[RPV_VK : RPV_DEFERRED + 8]
    out[RPV_START_PC] = rpv_a[RPV_START_PC]
    out[RPV_NEXT_PC] = rpv_b[RPV_NEXT_PC]
    out[RPV_START_SHARD] = rpv_a[RPV_START_SHARD]
    out[RPV_NEXT_SHARD] = rpv_b[RPV_NEXT_SHARD]
    out[RPV_START_EXEC_SHARD] = rpv_a[RPV_START_EXEC_SHARD]
    out[RPV_NEXT_EXEC_SHARD] = rpv_b[RPV_NEXT_EXEC_SHARD]
    out[RPV_PREV_INIT_ADDR : RPV_PREV_INIT_ADDR + 32] = rpv_a[
        RPV_PREV_INIT_ADDR : RPV_PREV_INIT_ADDR + 32
    ]
    out[RPV_LAST_INIT_ADDR : RPV_LAST_INIT_ADDR + 32] = rpv_b[
        RPV_LAST_INIT_ADDR : RPV_LAST_INIT_ADDR + 32
    ]
    out[RPV_PREV_FIN_ADDR : RPV_PREV_FIN_ADDR + 32] = rpv_a[
        RPV_PREV_FIN_ADDR : RPV_PREV_FIN_ADDR + 32
    ]
    out[RPV_LAST_FIN_ADDR : RPV_LAST_FIN_ADDR + 32] = rpv_b[
        RPV_LAST_FIN_ADDR : RPV_LAST_FIN_ADDR + 32
    ]
    out[RPV_EXIT_CODE] = rpv_b[RPV_EXIT_CODE]
    ga = (
        np.asarray(rpv_a[RPV_GLOBAL_SUM : RPV_GLOBAL_SUM + 7], np.uint32),
        np.asarray(rpv_a[RPV_GLOBAL_SUM + 7 : RPV_GLOBAL_SUM + 14], np.uint32),
    )
    gb = (
        np.asarray(rpv_b[RPV_GLOBAL_SUM : RPV_GLOBAL_SUM + 7], np.uint32),
        np.asarray(rpv_b[RPV_GLOBAL_SUM + 7 : RPV_GLOBAL_SUM + 14], np.uint32),
    )
    dig = host_sum_digest([ga, gb])
    out[RPV_GLOBAL_SUM : RPV_GLOBAL_SUM + 7] = [int(v) for v in dig[0]]
    out[RPV_GLOBAL_SUM + 7 : RPV_GLOBAL_SUM + 14] = [int(v) for v in dig[1]]
    out[RPV_PC_START] = rpv_a[RPV_PC_START]
    out[RPV_START_RECON : RPV_START_RECON + 8] = rpv_a[
        RPV_START_RECON : RPV_START_RECON + 8
    ]
    out[RPV_END_RECON : RPV_END_RECON + 8] = rpv_b[
        RPV_END_RECON : RPV_END_RECON + 8
    ]
    out[RPV_VK_ROOT : RPV_VK_ROOT + 8] = rpv_a[RPV_VK_ROOT : RPV_VK_ROOT + 8]
    out[RPV_IS_COMPLETE] = 1 if _is_complete(out) else 0
    return out


def _rpv_point(h):
    """(x, y) handle pair from 14 consecutive gsum handles."""
    return (h[:7], h[7:14])


def _bind_completeness(t, rpv, digest_point):
    """is_complete-gated completeness constraints (reference root.rs)."""
    ic = rpv[RPV_IS_COMPLETE]
    zero = t.const(0)
    t.assert_eq(ic * (ic - 1), zero)  # boolean
    t.assert_eq(ic * (rpv[RPV_START_SHARD] - 1), zero)
    t.assert_eq(ic * rpv[RPV_NEXT_PC], zero)
    t.assert_eq(ic * rpv[RPV_EXIT_CODE], zero)
    t.assert_eq(ic * (rpv[RPV_START_PC] - rpv[RPV_PC_START]), zero)
    for i in range(8):
        t.assert_eq(ic * rpv[RPV_START_RECON + i], zero)
        t.assert_eq(
            ic * (rpv[RPV_END_RECON + i] - rpv[RPV_DEFERRED + i]), zero
        )
    for i in range(32):
        t.assert_eq(ic * rpv[RPV_PREV_INIT_ADDR + i], zero)
        t.assert_eq(ic * rpv[RPV_PREV_FIN_ADDR + i], zero)
    assert_digest_zero(t, ic, digest_point)


def lift_shard(machine, vk, shard_proof, config=None,
               reconstruct_digest=None, vk_root=None, setup_only=False,
               phantom=False, device=None):
    """One recursion proof attesting one MIPS shard proof, public values =
    the canonical RPV. The shard's own 231 public values enter as HINTS,
    bound by the traced shard verifier's transcript, and every RPV field is
    asserted against them in-circuit.

    vk_root is CARRIED (an unconstrained input at the leaf): a lift cannot
    attest its own vk's registry membership — the parent join does, against
    this field. The traced program never reads the root handles, so the
    lift vk is independent of the root value (what lets the registry be
    built from setup-only lifts before any proving).

    setup_only=True: trace + setup (populating the shape cache) and return
    (rec_machine, rec_vk, None) without proving — used to enumerate the
    registry's lift vks.

    phantom=True (implies setup_only): `shard_proof` is a STRUCTURAL
    stand-in (recursion/shape_universe.py phantom_shard_proof) with garbage
    values — the tracer runs without concrete evaluation, so the SAME
    program (and lift vk) falls out for any real proof of that shape: the
    reference's offline vk enumeration (prover/src/shapes.rs
    build_vk_map), no proving required.

    device: where the recursion proof is made (StarkMachine.prove: None is
    the GPU, a torch device, or "host")."""
    extras = [int(x) for x in vk.extra_observations]
    if phantom:
        setup_only = True
        rpv_vals = None
        t = Tracer(num_inputs=RPV_WIDTH, phantom=True)
    else:
        rpv_vals = shard_rpv(machine, vk, shard_proof,
                             reconstruct_digest=reconstruct_digest,
                             vk_root=vk_root)
        t = Tracer(num_inputs=RPV_WIDTH, input_values=rpv_vals)
    rpv = [t.input(i) for i in range(RPV_WIDTH)]
    vk_h = rpv[RPV_VK : RPV_VK + 8]
    extra_h = [rpv[RPV_PC_START]] if extras else []
    pv_h = [t.hint(int(v)) for v in shard_proof.public_values]
    res = traced_verify_shard(t, machine, vk, shard_proof, pv_h, vk_h,
                              extra_h)

    # bind the summary to the shard pv
    def eq_range(rpv_off, pv_off, k):
        for i in range(k):
            t.assert_eq(rpv[rpv_off + i], pv_h[pv_off + i])

    eq_range(RPV_DIGEST, PV_DIGEST, 32)
    eq_range(RPV_DEFERRED, PV_DEFERRED, 8)
    t.assert_eq(rpv[RPV_START_PC], pv_h[PV_START_PC])
    t.assert_eq(rpv[RPV_NEXT_PC], pv_h[PV_NEXT_PC])
    t.assert_eq(rpv[RPV_START_SHARD], pv_h[PV_SHARD])
    t.assert_eq(rpv[RPV_NEXT_SHARD], pv_h[PV_SHARD] + 1)
    t.assert_eq(rpv[RPV_START_EXEC_SHARD], pv_h[PV_EXECUTION_SHARD])
    # chip presence is static per proof shape (part of the lift's shape
    # key), so the per-kind rules compile into the traced program
    # (reference circuit/machine/core.rs shard-kind constraints)
    has_cpu = "Cpu" in shard_proof.chip_names
    if has_cpu:
        t.assert_eq(rpv[RPV_NEXT_EXEC_SHARD], pv_h[PV_EXECUTION_SHARD] + 1)
    else:
        t.assert_eq(rpv[RPV_NEXT_EXEC_SHARD], pv_h[PV_EXECUTION_SHARD])
        # a non-cpu (memory) shard cannot move the pc
        t.assert_eq(pv_h[PV_START_PC], pv_h[PV_NEXT_PC])
    eq_range(RPV_PREV_INIT_ADDR, PV_PREV_INIT_ADDR, 32)
    eq_range(RPV_LAST_INIT_ADDR, PV_LAST_INIT_ADDR, 32)
    eq_range(RPV_PREV_FIN_ADDR, PV_PREV_FIN_ADDR, 32)
    eq_range(RPV_LAST_FIN_ADDR, PV_LAST_FIN_ADDR, 32)
    # shards without memory endpoint chips must carry the chains unchanged
    if "MemoryInit" not in shard_proof.chip_names:
        for i in range(32):
            t.assert_eq(pv_h[PV_PREV_INIT_ADDR + i], pv_h[PV_LAST_INIT_ADDR + i])
    if "MemoryFinal" not in shard_proof.chip_names:
        for i in range(32):
            t.assert_eq(pv_h[PV_PREV_FIN_ADDR + i], pv_h[PV_LAST_FIN_ADDR + i])
    t.assert_eq(rpv[RPV_EXIT_CODE], pv_h[PV_EXIT_CODE])
    # core leaves carry the deferred reconstruct digest unchanged
    for i in range(8):
        t.assert_eq(rpv[RPV_START_RECON + i], rpv[RPV_END_RECON + i])
    zero = t.const(0)
    for i in range(PV_PADDING, len(pv_h)):
        t.assert_eq(pv_h[i], zero)

    # septic digest: accumulate the constraint-bound per-chip global sums
    points = [_rpv_point(gs) for _name, gs in res["gsums"]]
    dig = traced_sum_digest(t, points)
    for i in range(7):
        t.assert_eq(rpv[RPV_GLOBAL_SUM + i], dig[0][i])
        t.assert_eq(rpv[RPV_GLOBAL_SUM + 7 + i], dig[1][i])
    _bind_completeness(t, rpv, dig)

    prog = t.program()
    key = ("mlift", len(extras)) + _shape_key(machine, shard_proof, vk)
    if setup_only:
        from .pipeline import _setup_cached

        rm, rvk = _setup_cached(key, prog, config)
        return rm, rvk, None
    rm, rvk, rproof = _prove_cached(key, prog, rpv_vals, t.hint_values,
                                    config, tracer=t, device=device)
    return rm, rvk, rproof.shard_proofs[0]


def join(side_a, side_b, config=None, registry=None,
         leaf_flags=(False, False), phantom=False, registry_depth=None,
         device=None):
    """One recursion proof attesting two adjacent child recursion proofs
    (lifts or joins), chaining their boundaries and accumulating their
    septic sums.

    Child vk binding (reference machine/compress.rs vk Merkle proofs +
    prover/src/shapes.rs vk_map): with a `registry`, EVERY child vk enters
    as a HINTED vk whose registry MEMBERSHIP is verified in-circuit against
    the RPV's vk_root field — lifts AND joins are registry members (the
    full enumeration of shape_universe.build_full_registry), so the join
    program set is finite and value-independent, and the root-field chain
    (asserted below) carries the registry root up unchanged. Without a
    registry, child vks are pinned as constants (legacy mode).

    phantom=True: structural tracing over phantom child proofs — the
    enumeration path; pass `registry_depth` (the fixed membership-path
    length every real registry uses) instead of a registry. Returns
    (rec_machine, rec_vk, None)."""
    (ma, vka, spa), (mb, vkb, spb) = side_a, side_b
    rpv_a = [int(v) for v in spa.public_values]
    rpv_b = [int(v) for v in spb.public_values]
    assert len(rpv_a) == RPV_WIDTH and len(rpv_b) == RPV_WIDTH
    depth = registry.depth if registry is not None else registry_depth
    if phantom:
        out_vals = None
        t = Tracer(num_inputs=RPV_WIDTH, phantom=True)
    else:
        out_vals = combine_rpv(rpv_a, rpv_b)
        t = Tracer(num_inputs=RPV_WIDTH, input_values=out_vals)
    rpv = [t.input(i) for i in range(RPV_WIDTH)]
    a_h = [t.hint(v) for v in rpv_a]
    b_h = [t.hint(v) for v in rpv_b]
    root_h = rpv[RPV_VK_ROOT : RPV_VK_ROOT + 8]

    def child_vk_handles(vk_c, _is_leaf):
        """Hinted + membership-verified under a registry, else consts."""
        if depth is not None:
            import numpy as np

            from .vk_registry import traced_membership

            vk_h = [t.hint(int(v)) for v in vk_c.commit]
            if phantom:
                idx, path = 0, [np.zeros(8, np.uint32)] * depth
            else:
                idx, path = registry.membership(vk_c.commit)
                assert len(path) == depth
            traced_membership(t, vk_h, root_h, idx, path)
            return vk_h
        return [t.const(int(v)) for v in vk_c.commit]

    # child RPVs are hints bound by the child transcript replay inside
    # traced_verify_shard; child vks bound per the policy above
    vk_a = child_vk_handles(vka, leaf_flags[0])
    vk_b = child_vk_handles(vkb, leaf_flags[1])
    traced_verify_shard(t, ma, vka, spa, a_h, vk_a)
    traced_verify_shard(t, mb, vkb, spb, b_h, vk_b)

    def eq3(off, k=1):
        """rpv[off..] == a_h[off..] == b_h[off..]"""
        for i in range(k):
            t.assert_eq(a_h[off + i], b_h[off + i])
            t.assert_eq(rpv[off + i], a_h[off + i])

    eq3(RPV_VK, 8)  # same inner MIPS machine
    eq3(RPV_VK_ROOT, 8)  # same allowed-vk registry root
    eq3(RPV_DIGEST, 32)  # same committed digest
    eq3(RPV_DEFERRED, 8)
    eq3(RPV_PC_START)
    # boundary chaining
    t.assert_eq(a_h[RPV_NEXT_PC], b_h[RPV_START_PC])
    t.assert_eq(a_h[RPV_NEXT_SHARD], b_h[RPV_START_SHARD])
    t.assert_eq(a_h[RPV_NEXT_EXEC_SHARD], b_h[RPV_START_EXEC_SHARD])
    for i in range(32):
        t.assert_eq(a_h[RPV_LAST_INIT_ADDR + i], b_h[RPV_PREV_INIT_ADDR + i])
        t.assert_eq(a_h[RPV_LAST_FIN_ADDR + i], b_h[RPV_PREV_FIN_ADDR + i])
    for i in range(8):
        t.assert_eq(a_h[RPV_END_RECON + i], b_h[RPV_START_RECON + i])
    # summary = a.start .. b.next
    def out_eq(off, src, src_off=None, k=1):
        so = off if src_off is None else src_off
        for i in range(k):
            t.assert_eq(rpv[off + i], src[so + i])

    out_eq(RPV_START_PC, a_h)
    out_eq(RPV_NEXT_PC, b_h)
    out_eq(RPV_START_SHARD, a_h)
    out_eq(RPV_NEXT_SHARD, b_h)
    out_eq(RPV_START_EXEC_SHARD, a_h)
    out_eq(RPV_NEXT_EXEC_SHARD, b_h)
    out_eq(RPV_PREV_INIT_ADDR, a_h, k=32)
    out_eq(RPV_LAST_INIT_ADDR, b_h, k=32)
    out_eq(RPV_PREV_FIN_ADDR, a_h, k=32)
    out_eq(RPV_LAST_FIN_ADDR, b_h, k=32)
    out_eq(RPV_EXIT_CODE, b_h)
    out_eq(RPV_START_RECON, a_h, k=8)
    out_eq(RPV_END_RECON, b_h, k=8)
    # children must be partial ranges; the flag is decided at this node
    zero = t.const(0)
    t.assert_eq(a_h[RPV_IS_COMPLETE], zero)
    t.assert_eq(b_h[RPV_IS_COMPLETE], zero)
    # septic accumulation on the curve
    dig = traced_sum_digest(
        t,
        [
            _rpv_point(a_h[RPV_GLOBAL_SUM : RPV_GLOBAL_SUM + 14]),
            _rpv_point(b_h[RPV_GLOBAL_SUM : RPV_GLOBAL_SUM + 14]),
        ],
    )
    for i in range(7):
        t.assert_eq(rpv[RPV_GLOBAL_SUM + i], dig[0][i])
        t.assert_eq(rpv[RPV_GLOBAL_SUM + 7 + i], dig[1][i])
    _bind_completeness(t, rpv, dig)

    prog = t.program()
    if depth is not None:
        # hinted children: the program is child-vk-VALUE independent, so
        # the key carries only structure (what makes joins enumerable)
        def _struct(m, sp, vk_c):
            ci = tuple(
                (name, dom.log_n, tuple(dims), bool(local_only))
                for name, dom, dims, local_only in vk_c.chip_information
            )
            return _shape_key(m, sp) + (ci,)

        key = (("mjoin2", depth) + _struct(ma, spa, vka)
               + _struct(mb, spb, vkb))
    else:
        key = (("mjoin", None, tuple(leaf_flags))
               + _shape_key(ma, spa, vka) + _shape_key(mb, spb, vkb))
    if phantom:
        from .pipeline import _setup_cached

        rm, rvk = _setup_cached(key, prog, config)
        return rm, rvk, None
    rm, rvk, rproof = _prove_cached(key, prog, out_vals, t.hint_values,
                                    config, tracer=t, device=device)
    return rm, rvk, rproof.shard_proofs[0]


REQUIRED_CHIPS = {"Program", "Byte", "MemoryLocal", "Global"}


def build_lift_registry(machine, vk, shard_proofs, config=None):
    """The allowed-vk registry for these shards: one SETUP-ONLY lift per
    distinct proof shape (no proving — lift vks are input-independent), its
    vks committed in a Poseidon2 Merkle tree (recursion/vk_registry.py)."""
    import numpy as np

    from .pipeline import _shape_key
    from .vk_registry import VkRegistry

    seen = {}
    for sp in shard_proofs:
        key = _shape_key(machine, sp, vk)
        if key in seen:
            continue
        _rm, rvk, _ = lift_shard(machine, vk, sp, config=config,
                                 setup_only=True)
        seen[key] = np.asarray(rvk.commit, np.uint32)
    return VkRegistry(list(seen.values()))


def compress(machine, vk, machine_proof, config=None,
             reconstruct_digest=None, registry=None, device=None):
    """Lift every MIPS shard, then reduce pairwise to ONE recursion proof
    whose public values are the root RPV (is_complete = 1 for a full
    halting execution). Every layer chains boundaries and accumulates the
    septic global sum in-circuit.

    registry: an allowed-vk VkRegistry (default: the FULL lift+join
    enumeration over these shards' shapes — shape_universe.py
    build_full_registry). Its root rides every RPV's vk_root field; every
    join verifies BOTH children's vks as registry MEMBERS in-circuit
    (lifts and joins alike), so the final proof carries the registry root
    it ran under and the root alone is the trust anchor
    (verify_compressed checks the final rec_vk against the registry)."""
    shard_proofs = machine_proof.shard_proofs
    for sp in shard_proofs:
        missing = REQUIRED_CHIPS - set(sp.chip_names)
        assert not missing, f"shard missing required chips: {sorted(missing)}"
    if registry is None:
        from .shape_universe import build_full_registry

        shapes = {
            tuple(zip(sp.chip_names,
                      (v.log_degree for v in sp.opened_values)))
            for sp in shard_proofs
        }
        registry, _depth = build_full_registry(machine, vk, list(shapes),
                                               config=config)
    else:
        # fail fast: every reachable lift vk must be a registry member
        # (setup-only, cached) before any proving starts
        for sp in shard_proofs:
            _rm, rvk, _ = lift_shard(machine, vk, sp, config=config,
                                     setup_only=True)
            registry.membership(rvk.commit)
    root = [int(v) for v in registry.root]
    # worker-pool tree reduce (reference prover/src/lib.rs:649-830): lifts
    # are independent, as are the joins within one layer. The setup caches
    # are pre-warmed above (setup-only lifts), so workers only trace+prove;
    # tracing is GIL-bound but the prove legs (numpy/native/device) overlap.
    import os
    from concurrent.futures import ThreadPoolExecutor

    workers = int(os.environ.get("ZIREN_RECURSION_WORKERS",
                                 str(min(len(shard_proofs), os.cpu_count() or 4))))

    def one_lift(sp):
        return lift_shard(machine, vk, sp, config=config,
                          reconstruct_digest=reconstruct_digest,
                          vk_root=root, device=device)

    if workers > 1 and len(shard_proofs) > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            layer = list(pool.map(one_lift, shard_proofs))
    else:
        layer = [one_lift(sp) for sp in shard_proofs]
    leaf = [True] * len(layer)
    while len(layer) > 1:
        pairs = [
            (layer[i], layer[i + 1], (leaf[i], leaf[i + 1]))
            for i in range(0, len(layer) - 1, 2)
        ]

        def one_join(p):
            a, b, flags = p
            return join(a, b, config=config, registry=registry,
                        leaf_flags=flags, device=device)

        if workers > 1 and len(pairs) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                nxt = list(pool.map(one_join, pairs))
        else:
            nxt = [one_join(p) for p in pairs]
        nleaf = [False] * len(nxt)
        if len(layer) % 2:
            nxt.append(layer[-1])
            nleaf.append(leaf[-1])
        layer, leaf = nxt, nleaf
    return layer[0]


def verify_compressed(machine, vk, rec_machine, rec_vk, final_sp,
                      pc_start=None, vk_root=None, registry=None):
    """Host-side root checks for a compressed proof (reference
    verify.rs:299 verify_compressed): the single recursion proof verifies,
    its RPV pins the expected MIPS vk and program entry, and is_complete=1
    (which in-circuit implies shard 1..halt coverage, exit 0 and a balanced
    septic digest). vk_root (when given) must match the RPV's registry-root
    field (reference verify.rs vk Merkle-root check).

    registry: the full lift+join allowed-vk registry
    (shape_universe.build_full_registry, reference build_vk_map which
    covers compress shapes too). When given, rec_vk itself must be a
    MEMBER and the RPV root must equal the registry root — the registry
    root is then the complete trust anchor (every vk in the tree, root
    included, was membership-checked either in-circuit by its parent join
    or right here). Without it, the consumer must pin rec_vk out-of-band.
    Returns the committed_value_digest bytes."""
    from ..stark.proof import MachineProof
    from ..stark.verifier import VerificationError

    rec_machine.verify(rec_vk, MachineProof([final_sp]))
    rpv = [int(v) for v in final_sp.public_values]
    if len(rpv) != RPV_WIDTH:
        raise VerificationError("compressed proof: bad public-value width")
    if rpv[RPV_VK : RPV_VK + 8] != [int(v) for v in vk.commit]:
        raise VerificationError("compressed proof: wrong MIPS vk")
    if registry is not None:
        try:
            registry.membership(rec_vk.commit)
        except KeyError:
            raise VerificationError(
                "compressed proof: rec vk not in the allowed-vk registry")
        if vk_root is None:
            vk_root = registry.root
    if vk_root is not None and rpv[RPV_VK_ROOT : RPV_VK_ROOT + 8] != [
        int(v) for v in vk_root
    ]:
        raise VerificationError("compressed proof: wrong allowed-vk root")
    if rpv[RPV_IS_COMPLETE] != 1:
        raise VerificationError("compressed proof: incomplete execution")
    extras = [int(x) for x in vk.extra_observations]
    expect_entry = extras[0] if extras else pc_start
    if expect_entry is not None and rpv[RPV_PC_START] != expect_entry:
        raise VerificationError("compressed proof: wrong program entry")
    return bytes(rpv[RPV_DIGEST + i] & 0xFF for i in range(32))
