"""Shard prover: commit main -> perm -> quotient -> FRI open.

Transcript order is pinned to the reference (crates/stark/src/prover.rs:296-652):
observe pv, main commit; sample 2 perm challenges; observe perm commit +
cumulative sums; sample alpha; observe quotient commit; sample zeta; pcs.open.
"""

from __future__ import annotations

import numpy as np

from ..core import ext as E
from ..core import field as F
from .folder import QuotientFolder, TraceFolder
from .permutation import generate_permutation_trace
from .proof import (
    AirOpenedValues,
    ChipOpenedValues,
    ShardCommitment,
    ShardProof,
)


def _unflatten_ext_cols(mat_flat: np.ndarray) -> list:
    """(n, w*4) base matrix -> list of w arrays (n, 4)."""
    n, wd = mat_flat.shape
    return [mat_flat[:, 4 * c : 4 * c + 4] for c in range(wd // 4)]


def prove_shard(machine, pk, record, challenger):
    """Prove one shard. `challenger` must already have observed the vk."""
    config = machine.config
    pcs = config.pcs

    from .shape import record_traces

    named_traces = record_traces(machine, record)
    # sort by height desc, stable (reference: prover.rs commit: sort by height)
    named_traces.sort(key=lambda t: -t[1].shape[0])
    chips = [c for c, _ in named_traces]
    traces = [t for _, t in named_traces]
    pv = record.public_values
    public_values = pv.to_list() if hasattr(pv, "to_list") else list(pv)

    trace_domains = [pcs.natural_domain_for_degree(t.shape[0]) for t in traces]
    main_commit, main_data = pcs.commit(list(zip(trace_domains, traces)))

    ch = challenger
    ch.observe_slice(np.asarray(public_values, dtype=np.uint32))
    config.pcs.mmcs.observe_root(ch, main_commit)

    perm_challenges = (ch.sample_ext(), ch.sample_ext())

    # permutation traces
    perm_flats, cumsums, all_lookups = [], [], []
    for chip, trace in zip(chips, traces):
        prep = pk.preprocessed_by_name.get(chip.name)
        fl = TraceFolder(prep, trace, public_values)
        chip.air.eval(fl)
        perm, cumsum = generate_permutation_trace(
            fl.sends, fl.receives, trace.shape[0], perm_challenges, chip.batch_size
        )
        perm_flats.append(perm.reshape(trace.shape[0], -1))
        cumsums.append(cumsum)
        all_lookups.append((fl.sends, fl.receives))

    perm_commit, perm_data = pcs.commit(list(zip(trace_domains, perm_flats)))
    config.pcs.mmcs.observe_root(ch, perm_commit)
    global_sums = []
    for chip, trace, cumsum in zip(chips, traces, cumsums):
        if chip.commit_scope.name == "Global":
            gsum = trace[-1, -14:].astype(np.uint32)
        else:
            gsum = np.zeros(14, dtype=np.uint32)
        global_sums.append(gsum)
        ch.observe_slice(cumsum)
        ch.observe_slice(gsum)

    alpha = ch.sample_ext()

    # quotient evaluation per chip
    quotient_domains = [
        d.create_disjoint_domain(1 << (d.log_n + c.log_quotient_degree))
        for d, c in zip(trace_domains, chips)
    ]
    q_domains_and_chunks = []
    for i, (chip, tdom, qdom) in enumerate(zip(chips, trace_domains, quotient_domains)):
        assert chip.log_quotient_degree <= config.fri.log_blowup, (
            f"chip {chip.name}: quotient degree 2^{chip.log_quotient_degree} exceeds blowup"
        )
        qn = qdom.size
        next_step = qn // tdom.size
        prep_idx = pk.chip_ordering.get(chip.name)
        if prep_idx is not None:
            prep_q = pcs.get_evaluations_on_domain(pk.data, prep_idx, qdom)
        else:
            prep_q = np.zeros((qn, 0), dtype=np.uint32)
        main_q = pcs.get_evaluations_on_domain(main_data, i, qdom)
        perm_q = pcs.get_evaluations_on_domain(perm_data, i, qdom)
        sels = tdom.selectors_on_coset(qdom)

        prep_next_q = np.roll(prep_q, -next_step, axis=0)
        main_next_q = np.roll(main_q, -next_step, axis=0)
        alphas_rev = E.epowers(alpha, chip.num_constraints)[::-1].copy()
        folder = QuotientFolder(
            prep_local=[prep_q[:, c] for c in range(prep_q.shape[1])],
            prep_next=[prep_next_q[:, c] for c in range(prep_q.shape[1])],
            main_local=[main_q[:, c] for c in range(main_q.shape[1])],
            main_next=[main_next_q[:, c] for c in range(main_q.shape[1])],
            sels=sels,
            public_values=public_values,
            powers_of_alpha_rev=alphas_rev,
            perm_challenges=perm_challenges,
            local_cumulative_sum=cumsums[i],
            global_cumulative_sum=global_sums[i],
        )
        if chip.perm_width:
            perm_next_q = np.roll(perm_q, -next_step, axis=0)
            folder.set_perm(
                _unflatten_ext_cols(perm_q), _unflatten_ext_cols(perm_next_q)
            )
        chip.eval_with_perm(folder)
        assert folder._idx == chip.num_constraints, (
            f"chip {chip.name}: evaluated {folder._idx} constraints, "
            f"expected {chip.num_constraints}"
        )
        quotient = E.emul_base(folder.acc, sels["inv_zeroifier"])  # (qn, 4)
        flat = quotient.reshape(qn, 4)
        chunks = qdom.split_evals(chip.quotient_degree, flat)
        for sub_dom, chunk in zip(qdom.split_domains(chip.quotient_degree), chunks):
            q_domains_and_chunks.append((sub_dom, chunk))

    quotient_commit, quotient_data = pcs.commit(q_domains_and_chunks)
    config.pcs.mmcs.observe_root(ch, quotient_commit)

    zeta = ch.sample_ext()

    # opening points
    prep_points = []
    for name, dom, _dims, local_only in pk.chip_information:
        pts = [zeta] if local_only else [zeta, dom.next_point(zeta)]
        prep_points.append(pts)
    main_points = [
        [zeta] if c.local_only else [zeta, d.next_point(zeta)]
        for c, d in zip(chips, trace_domains)
    ]
    perm_points = [[zeta, d.next_point(zeta)] for d in trace_domains]
    quotient_points = [[zeta] for _ in q_domains_and_chunks]

    open_rounds = []
    if pk.data is not None:
        open_rounds.append((pk.data, prep_points))
    open_rounds += [
        (main_data, main_points),
        (perm_data, perm_points),
        (quotient_data, quotient_points),
    ]
    opened, fri_proof = pcs.open(open_rounds, ch)
    if pk.data is not None:
        prep_vals, main_vals, perm_vals, quot_vals = opened
    else:
        main_vals, perm_vals, quot_vals = opened
        prep_vals = []

    # assemble per-chip opened values
    opened_chips = []
    q_off = 0
    for i, chip in enumerate(chips):
        prep_idx = pk.chip_ordering.get(chip.name)
        if prep_idx is not None:
            pv_ = prep_vals[prep_idx]
            prep_open = AirOpenedValues(
                local=list(pv_[0]),
                next=list(pv_[1]) if len(pv_) > 1 else [],
            )
        else:
            prep_open = AirOpenedValues([], [])
        mv = main_vals[i]
        main_open = AirOpenedValues(
            local=list(mv[0]), next=list(mv[1]) if len(mv) > 1 else []
        )
        perm_open = AirOpenedValues(
            local=list(perm_vals[i][0]), next=list(perm_vals[i][1])
        )
        q = chips[i].quotient_degree
        quotient_open = [list(quot_vals[q_off + j][0]) for j in range(q)]
        q_off += q
        opened_chips.append(
            ChipOpenedValues(
                preprocessed=prep_open,
                main=main_open,
                permutation=perm_open,
                quotient=quotient_open,
                local_cumulative_sum=cumsums[i],
                global_cumulative_sum=global_sums[i],
                log_degree=trace_domains[i].log_n,
            )
        )

    return ShardProof(
        commitment=ShardCommitment(main_commit, perm_commit, quotient_commit),
        opened_values=opened_chips,
        opening_proof=fri_proof,
        chip_names=[c.name for c in chips],
        public_values=public_values,
    )
