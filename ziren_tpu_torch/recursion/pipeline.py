"""Recursion pipeline entry points: lift / join / compress
(reference: crates/prover/src/lib.rs — shard proofs are lifted into
recursion proofs, then reduced pairwise to a single proof).

Public-value convention: a lift proof's inputs (= its public values) are
[inner vk commit (8) | inner shard public values | vk extra observations];
a join proof's inputs concatenate both children's inputs, so the final
compressed proof still exposes every shard's public interface. Joins can
additionally enforce cross-shard chaining in-circuit (`chain=`).

Trust model (reference VERIFY_VK analogue): joins PIN their children's
recursion vks in-circuit, so each layer's vk transitively attests the
whole verifier tree below it — the consumer checks only the TOP recursion
vk plus the base machine's vk carried in the public values.
"""

from __future__ import annotations

from .dsl import Tracer, interpret
from .machine import prove_recursion, recursion_machine
from .verifier import traced_verify_shard

# Shape cache (the reference's shape system, emergent form): the traced
# verifier program depends only on the inner proof's SHAPE (chip set, log
# degrees, pv length, FRI params) — not its values — so same-shaped proofs
# share one recursion machine + vk.
_SHAPE_CACHE: dict = {}


def _shape_key(machine, shard_proof, vk=None):
    """Cache key for the traced verifier program. Includes the inner vk
    identity (commit + preprocessed chip dims): the traced program bakes
    vk-dependent constants (prep round dims, Merkle depths), so two guests
    with equal trace shape but different programs must not collide."""
    fri = machine.config.fri
    vk_part = ()
    if vk is not None:
        vk_part = (
            tuple(int(v) for v in vk.commit),
            tuple(
                (name, dom.log_n, tuple(dims), bool(local_only))
                for name, dom, dims, local_only in vk.chip_information
            ),
        )
    return (
        tuple(shard_proof.chip_names),
        tuple(v.log_degree for v in shard_proof.opened_values),
        len(shard_proof.public_values),
        fri.log_blowup, fri.num_queries, fri.proof_of_work_bits,
    ) + vk_part


def _config_key(config):
    """Identity of the PROVING config (the machine the recursion proof is
    produced under) — distinguishes inner (KB) lifts from outer (BN254)
    wraps of the same inner shape."""
    if config is None:
        return ("dev",)
    fri = config.fri
    return (getattr(config, "commit_kind", "kb"), fri.log_blowup,
            fri.num_queries, fri.proof_of_work_bits)


def _setup_cached(key, prog, config):
    """Setup (or fetch) the recursion machine + keys for a traced program.
    Setup depends only on the PROGRAM, never on input/hint values — which
    is what lets the allowed-vk registry be enumerated without proving."""
    cached = _SHAPE_CACHE.get(key)
    if cached is None:
        rm, _comp = recursion_machine(prog, config)
        rpk, rvk = rm.setup(prog)
        if len(_SHAPE_CACHE) > 64:
            _SHAPE_CACHE.clear()
        _SHAPE_CACHE[key] = (rm, rpk, rvk, (len(prog.ops), prog.num_regs))
        return rm, rvk
    rm, rpk, rvk, sig = cached
    assert sig == (len(prog.ops), prog.num_regs), (
        "shape-cache collision: cached recursion program does not match "
        "the freshly traced one"
    )
    return rm, rvk


def _prove_cached(key, prog, inputs, hints, config, tracer=None,
                  device=None):
    """Prove one traced program under its cached machine and keys.
    `device` is StarkMachine.prove's: None is the GPU, a torch device runs
    the torch shard prover there, "host" is the numpy prover."""
    from .machine import _Record
    import numpy as np

    from .dsl import Op

    _setup_cached(key, prog, config)
    rm, rpk, rvk, _sig = _SHAPE_CACHE[key]
    if tracer is not None and tracer.input_values is not None:
        # the concrete tracer already evaluated every op — reuse its values
        vals = tracer.vals + [0] * (prog.num_regs - len(tracer.vals))
        regs = np.asarray(vals, dtype=np.uint32)
        outputs = [int(regs[a]) for op, a, _b, _c, _d in prog.ops
                   if op == Op.OUTPUT]
    else:
        outputs, regs = interpret(prog, inputs, return_regs=True,
                                  hints=hints)
    rec = _Record(inputs, regs)
    rec.public_values = list(inputs) + list(outputs)
    rproof = rm.prove(rpk, [rec], device=device)
    return rm, rvk, rproof


def lift(machine, vk, shard_proof, config=None, compact=False,
         device=None):
    """One recursion proof attesting one shard proof. Same-shaped inner
    proofs reuse one recursion machine + vk (the shape system).

    compact=True: the inner (vk commit, public values, extras) enter as
    HINTS and the proof exposes only their 8-felt Poseidon2 digest — the
    reference's RecursionPublicValues digest convention, wrap-ready. The
    consumer recomputes the digest from the expected vk/pv.

    device: where the recursion proof is made (StarkMachine.prove)."""
    from .verifier import traced_hash_rows

    extra = [int(x) for x in vk.extra_observations]
    flat = ([int(v) for v in vk.commit]
            + [int(v) for v in shard_proof.public_values] + extra)
    npv = len(shard_proof.public_values)
    if compact:
        t = Tracer(num_inputs=0, input_values=[])
        handles = [t.hint(v) for v in flat]
        inputs = []
    else:
        t = Tracer(num_inputs=len(flat), input_values=flat)
        handles = [t.input(i) for i in range(len(flat))]
        inputs = flat
    vk_h = handles[:8]
    pv_h = handles[8 : 8 + npv]
    extra_h = handles[8 + npv :]
    traced_verify_shard(t, machine, vk, shard_proof, pv_h, vk_h, extra_h)
    if compact:
        digest = traced_hash_rows(t, handles)
        for d in digest:
            t.output(d)
    prog = t.program()
    key = (("lift", compact, len(extra)) + _config_key(config)
           + _shape_key(machine, shard_proof, vk))
    rm, rvk, rproof = _prove_cached(key, prog, inputs, t.hint_values,
                                    config, tracer=t, device=device)
    return rm, rvk, rproof, inputs


def join(side_a, side_b, config=None, chain=None, device=None):
    """One recursion proof attesting two recursion proofs. Each side is
    (rec_machine, rec_vk, rec_shard_proof). `chain(t, pva_h, pvb_h)` may
    add cross-child constraints over the children's public-value handles
    (e.g. MIPS shard pc/digest chaining)."""
    (ma, vka, spa), (mb, vkb, spb) = side_a, side_b
    ins_a = [int(v) for v in vka.commit] + [int(v) for v in spa.public_values]
    ins_b = [int(v) for v in vkb.commit] + [int(v) for v in spb.public_values]
    inputs = ins_a + ins_b
    t = Tracer(num_inputs=len(inputs), input_values=inputs)
    off = 0

    def take(k):
        nonlocal off
        hs = [t.input(off + i) for i in range(k)]
        off += k
        return hs

    vka_h = take(8)
    pva_h = take(len(spa.public_values))
    vkb_h = take(8)
    pvb_h = take(len(spb.public_values))
    # pin the children's recursion vks IN-CIRCUIT (the reference bakes the
    # allowed recursion vks into the reduce program): the join's own vk now
    # attests exactly which child verifiers ran
    for h, v in zip(vka_h, vka.commit):
        t.assert_eq(h, t.const(int(v)))
    for h, v in zip(vkb_h, vkb.commit):
        t.assert_eq(h, t.const(int(v)))
    traced_verify_shard(t, ma, vka, spa, pva_h, vka_h)
    traced_verify_shard(t, mb, vkb, spb, pvb_h, vkb_h)
    if chain is not None:
        chain(t, pva_h, pvb_h)
    prog = t.program()
    key = (("join", chain is not None) + _config_key(config)
           + _shape_key(ma, spa, vka) + _shape_key(mb, spb, vkb))
    rm, rvk, rproof = _prove_cached(key, prog, inputs, t.hint_values,
                                    config, tracer=t, device=device)
    return rm, rvk, rproof, inputs


def lift_digest(vk, shard_proof):
    """The 8-felt digest a compact lift exposes, recomputed host-side."""
    import numpy as np

    from ..core import poseidon2 as p2

    flat = ([int(v) for v in vk.commit]
            + [int(v) for v in shard_proof.public_values]
            + [int(x) for x in vk.extra_observations])
    return [int(v) for v in p2.hash_rows(
        np.array([flat], dtype=np.uint32))[0]]


def compress(machine, vk, machine_proof, config=None, chain=None,
             device=None):
    """Lift every shard, then reduce pairwise to ONE recursion proof.
    `chain` applies only at the first join layer, where children are
    adjacent shard lifts (their pv carry the inner shard pv at a fixed
    offset)."""
    layer = []
    for sp in machine_proof.shard_proofs:
        rm, rvk, rproof, _ = lift(machine, vk, sp, config=config,
                                  device=device)
        layer.append((rm, rvk, rproof.shard_proofs[0]))
    first_layer = True
    while len(layer) > 1:
        nxt = []
        for i in range(0, len(layer) - 1, 2):
            rm, rvk, rproof, _ = join(
                layer[i], layer[i + 1], config=config,
                chain=chain if first_layer else None, device=device)
            nxt.append((rm, rvk, rproof.shard_proofs[0]))
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
        first_layer = False
    return layer[0]


def mips_shard_chain(t, pva_h, pvb_h):
    """Cross-shard chaining for adjacent MIPS shard lifts inside a join
    (mirrors machine/mips.py verify_mips_proof): the lift pv layout is
    [inner vk (8) | shard pv | extras], and the MIPS shard pv carry the
    40-word digest, start/next pc and shard index at fixed offsets."""
    from ..machine.messages import (PV_EXECUTION_SHARD, PV_NEXT_PC,
                                            PV_SHARD, PV_START_PC)

    off = 8  # skip the inner vk commit
    a = pva_h[off:]
    b = pvb_h[off:]
    # committed/deferred digests agree between adjacent shards
    for i in range(40):
        t.assert_eq(a[i], b[i])
    # pc chaining and consecutive shard numbering
    t.assert_eq(a[PV_NEXT_PC], b[PV_START_PC])
    t.assert_eq(b[PV_SHARD], a[PV_SHARD] + 1)
    t.assert_eq(b[PV_EXECUTION_SHARD], a[PV_EXECUTION_SHARD] + 1)


def shrink(rec_machine, rec_vk, rec_shard_proof, config=None, device=None):
    """Re-prove a compressed recursion proof (optionally at a smaller
    config) with compact public values — the artifact the BN254 wrap
    consumes (reference: shrink/wrap staging). Structurally this is `lift`
    applied to a recursion proof."""
    return lift(rec_machine, rec_vk, rec_shard_proof, config=config,
                compact=True, device=device)


def wrap_bn254(rec_machine, rec_vk, rec_shard_proof, config=None):
    """Re-prove the shrink output under the OUTER config: KoalaBear values,
    Poseidon2-BN254 Merkle commitments and a multifield BN254 challenger
    (stark/config.py OuterStarkConfig), making the proof cheap to verify
    inside a BN254 SNARK. Public values stay the compact 8-felt digest.
    (reference: prover/src/lib.rs:1009 wrap_bn254,
    recursion/core/src/stark/config.rs KoalaBearPoseidon2Outer). The outer
    config is not device_capable, so this proof is the host prover's."""
    from ..stark.config import outer_config

    return lift(rec_machine, rec_vk, rec_shard_proof,
                config=config or outer_config(), compact=True,
                device="host")
