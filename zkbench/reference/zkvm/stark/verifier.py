"""Shard verifier (reference: crates/stark/src/verifier.rs:30-450)."""

from __future__ import annotations

import numpy as np

from ..core import ext as E
from ..core import field as F
from .folder import VerifierFolder


class VerificationError(Exception):
    pass


def _stack(vals: list) -> np.ndarray:
    if not vals:
        return np.zeros((0, 4), dtype=np.uint32)
    return np.stack([np.asarray(v, np.uint32) for v in vals])


def _unflatten(vals: list) -> list:
    """Combine groups of 4 base-column ext openings into ext values:
    v = sum_e opened[4c+e] * X^e (X the ext monomial basis)."""
    out = []
    for c in range(len(vals) // 4):
        acc = E.ezero()
        for e in range(4):
            acc = E.eadd(acc, E.emul(np.asarray(vals[4 * c + e], np.uint32), E.monomial(e)))
        out.append(acc)
    return out


MAX_LOG_DEGREE = 26  # reference caps shard log degree (opts.rs shard sizing)


def verify_shard(machine, vk, proof, challenger):
    config = machine.config
    pcs = config.pcs
    # proof-supplied structure validation BEFORE any use (reference derives
    # the chip set from the machine; a malicious proof must not mint extra
    # chip instances, e.g. a second MemoryInit for the same address)
    if len(set(proof.chip_names)) != len(proof.chip_names):
        raise VerificationError("duplicate chip names in proof")
    unknown = [n for n in proof.chip_names if n not in machine.chip_by_name]
    if unknown:
        raise VerificationError(f"unknown chips in proof: {unknown}")
    chips = [machine.chip_by_name[n] for n in proof.chip_names]
    if len(chips) != len(proof.opened_values):
        raise VerificationError("chip opening length mismatch")
    if len(proof.public_values) < machine.num_public_values:
        raise VerificationError("public values length mismatch")
    if any(not (0 <= int(v) < F.P_INT) for v in proof.public_values):
        raise VerificationError("public value out of field range")
    machine_index = {c.name: i for i, c in enumerate(machine.chips)}
    prev = None
    for chip, vals in zip(chips, proof.opened_values):
        if not (0 <= vals.log_degree <= MAX_LOG_DEGREE):
            raise VerificationError(f"chip {chip.name}: log_degree out of range")
        # canonical prover order: height desc, machine order tie-break
        # (prover.rs sorts stably by height over machine order)
        key = (-vals.log_degree, machine_index[chip.name])
        if prev is not None and key < prev:
            raise VerificationError("chip ordering is not canonical")
        prev = key

    ch = challenger
    ch.observe_slice(np.asarray(proof.public_values, dtype=np.uint32))
    mmcs = machine.config.pcs.mmcs
    mmcs.observe_root(ch, proof.commitment.main)
    perm_challenges = (ch.sample_ext(), ch.sample_ext())
    mmcs.observe_root(ch, proof.commitment.permutation)
    for chip, vals in zip(chips, proof.opened_values):
        ch.observe_slice(np.asarray(vals.local_cumulative_sum, np.uint32))
        ch.observe_slice(np.asarray(vals.global_cumulative_sum, np.uint32))
        if chip.commit_scope.name == "Local" and np.any(
            np.asarray(vals.global_cumulative_sum) != 0
        ):
            raise VerificationError(
                f"chip {chip.name}: nonzero global cumulative sum on Local chip"
            )
        if chip.num_lookups == 0 and np.any(vals.local_cumulative_sum != 0):
            raise VerificationError(
                f"chip {chip.name}: nonzero local cumsum with no lookups"
            )
    alpha = ch.sample_ext()
    mmcs.observe_root(ch, proof.commitment.quotient)
    zeta = ch.sample_ext()

    trace_domains = [
        pcs.natural_domain_for_degree(1 << v.log_degree) for v in proof.opened_values
    ]

    # shape checks
    for chip, vals in zip(chips, proof.opened_values):
        if len(vals.main.local) != chip.width:
            raise VerificationError(f"chip {chip.name}: main width mismatch")
        if not chip.local_only and len(vals.main.next) != chip.width:
            raise VerificationError(f"chip {chip.name}: main next width mismatch")
        if len(vals.preprocessed.local) != chip.preprocessed_width:
            raise VerificationError(f"chip {chip.name}: prep width mismatch")
        if len(vals.permutation.local) != chip.perm_width * 4:
            raise VerificationError(f"chip {chip.name}: perm width mismatch")
        if len(vals.quotient) != chip.quotient_degree:
            raise VerificationError(f"chip {chip.name}: quotient chunks mismatch")

    # build PCS verification rounds
    chip_ordering = proof.chip_ordering
    prep_round = []
    for name, dom, dims, local_only in vk.chip_information:
        i = chip_ordering[name]
        vals = proof.opened_values[i].preprocessed
        pts = [(zeta, _stack(vals.local))]
        if not local_only:
            pts.append((dom.next_point(zeta), _stack(vals.next)))
        prep_round.append((dom, pts))
    main_round = []
    for chip, dom, vals in zip(chips, trace_domains, proof.opened_values):
        pts = [(zeta, _stack(vals.main.local))]
        if not chip.local_only:
            pts.append((dom.next_point(zeta), _stack(vals.main.next)))
        main_round.append((dom, pts))
    perm_round = [
        (
            dom,
            [
                (zeta, _stack(vals.permutation.local)),
                (dom.next_point(zeta), _stack(vals.permutation.next)),
            ],
        )
        for dom, vals in zip(trace_domains, proof.opened_values)
    ]
    quotient_round = []
    qc_domains_per_chip = []
    for chip, dom, vals in zip(chips, trace_domains, proof.opened_values):
        qdom = dom.create_disjoint_domain(1 << (dom.log_n + chip.log_quotient_degree))
        qc_domains = qdom.split_domains(chip.quotient_degree)
        qc_domains_per_chip.append(qc_domains)
        for sub_dom, chunk_vals in zip(qc_domains, vals.quotient):
            quotient_round.append((sub_dom, [(zeta, _stack(chunk_vals))]))

    rounds = []
    if vk.chip_information:
        rounds.append((vk.commit, prep_round))
    rounds += [
        (proof.commitment.main, main_round),
        (proof.commitment.permutation, perm_round),
        (proof.commitment.quotient, quotient_round),
    ]
    if not pcs.verify(rounds, proof.opening_proof, ch):
        raise VerificationError("invalid opening argument")

    # constraint checks at zeta
    for chip, dom, qc_domains, vals in zip(
        chips, trace_domains, qc_domains_per_chip, proof.opened_values
    ):
        sels = dom.selectors_at_point(zeta)
        quotient = _recompute_quotient(vals.quotient, qc_domains, zeta)
        folder = VerifierFolder(
            prep_local=vals.preprocessed.local,
            prep_next=vals.preprocessed.next if vals.preprocessed.next else [E.ezero()] * chip.preprocessed_width,
            main_local=vals.main.local,
            main_next=vals.main.next if vals.main.next else [E.ezero()] * chip.width,
            sels=sels,
            public_values=proof.public_values,
            alpha=alpha,
            perm_challenges=perm_challenges,
            local_cumulative_sum=vals.local_cumulative_sum,
            perm_local=_unflatten(vals.permutation.local),
            perm_next=_unflatten(vals.permutation.next),
            global_cumulative_sum=vals.global_cumulative_sum,
        )
        chip.eval_with_perm(folder)
        folded = E.emul(folder.acc, sels["inv_zeroifier"])
        if not np.array_equal(folded, quotient):
            raise VerificationError(f"chip {chip.name}: OOD evaluation mismatch")

    # local cumulative sum must vanish over the shard
    if np.any(proof.local_cumulative_sum() != 0):
        raise VerificationError("local cumulative sum is not zero")
    return True


def _recompute_quotient(quotient_vals, qc_domains, zeta):
    zps = []
    for i, dom in enumerate(qc_domains):
        acc = E.eone()
        for j, other in enumerate(qc_domains):
            if j == i:
                continue
            num = other.zp_at_point(zeta)
            den = other.zp_at_point(dom.first_point())
            acc = E.emul(acc, E.emul(num, E.einv(den)))
        zps.append(acc)
    total = E.ezero()
    for zp, chunk in zip(zps, quotient_vals):
        part = E.ezero()
        for e in range(4):
            part = E.eadd(part, E.emul(np.asarray(chunk[e], np.uint32), E.monomial(e)))
        total = E.eadd(total, E.emul(zp, part))
    return total


def _septic_zero_x():
    return np.zeros(7, dtype=np.uint32)
