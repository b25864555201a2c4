"""LogUp permutation argument (reference: crates/stark/src/permutation.rs).

Fingerprint of a lookup with values v_0..v_{k-1} and kind (argument index) a:
    rlc = alpha + beta^0 * a + sum_i beta^(i+1) * v_i
Each permutation-trace column (extension field) holds the sum over a batch of
`batch_size` lookups of  sign * multiplicity / rlc  (sends +, receives -);
the final column is the running total (cumulative sum). Constraints checked
by `eval_permutation_constraints` (same order as the reference):
    entry * prod(rlcs) == sum_i sign_i mult_i prod_{j!=i}(rlcs)   per batch col
    first row:  phi == sum of batch cols
    transition: phi_next - phi_local == sum of next batch cols
    last row:   phi == claimed local cumulative sum
"""

from __future__ import annotations

import numpy as np

from ..core import ext as E
from ..core import field as F
from .lookup import LookupScope


def perm_trace_width(num_lookups: int, batch_size: int) -> int:
    if num_lookups == 0:
        return 0
    return -(-num_lookups // batch_size) + 1


def _local(lookups):
    return [l for l in lookups if l.scope == LookupScope.Local]


def _chunks(sends, receives, batch_size):
    flat = [(l, True) for l in sends] + [(l, False) for l in receives]
    return [flat[i : i + batch_size] for i in range(0, len(flat), batch_size)]


def generate_permutation_trace(sends, receives, height, challenges, batch_size=2):
    """Numeric pass: lookups carry FV columns of shape (height,) base.

    Returns (perm_trace (height, width, 4) canonical uint32, cumsum (4,)).
    """
    sends, receives = _local(sends), _local(receives)
    n_lookups = len(sends) + len(receives)
    width = perm_trace_width(n_lookups, batch_size)
    if width == 0:
        return np.zeros((height, 0, 4), dtype=np.uint32), E.ezero()
    alpha, beta = challenges
    trace = np.zeros((height, width, 4), dtype=np.uint32)
    for ci, chunk in enumerate(_chunks(sends, receives, batch_size)):
        entry = E.ezero((height,))
        for lookup, is_send in chunk:
            rlc = np.broadcast_to(alpha, (height, 4)).copy()
            rlc = E.eadd(rlc, E.from_base(np.full(height, int(lookup.kind), np.uint32)))
            bpow = beta
            for v in lookup.values:
                va = np.broadcast_to(np.asarray(v.a, np.uint32), (height,))
                rlc = E.eadd(rlc, E.emul_base(np.broadcast_to(bpow, (height, 4)), va))
                bpow = E.emul(bpow, beta)
            mult = np.broadcast_to(np.asarray(lookup.multiplicity.a, np.uint32), (height,))
            if not is_send:
                mult = F.fneg(mult)
            entry = E.eadd(entry, E.emul_base(E.einv(rlc), mult))
        trace[:, ci] = entry
    row_sums = E.esum(trace[:, : width - 1], axis=1)  # (height, 4)
    phi = (np.cumsum(row_sums.astype(np.uint64), axis=0) % np.uint64(F.P_INT)).astype(
        np.uint32
    )
    trace[:, width - 1] = phi
    return trace, phi[-1].copy()


def eval_permutation_constraints(folder, sends, receives, batch_size=2,
                                 commit_scope=LookupScope.Local,
                                 main_width=None):
    """Folder-generic constraint pass; `folder.sends/receives` already filled
    by air.eval with folder-domain values."""
    # Global-scope chips: bind the last row's trailing 14 main columns to the
    # claimed global cumulative sum (reference: permutation.rs:336-349)
    if commit_scope == LookupScope.Global:
        g = folder.global_cumulative_sum
        for i in range(14):
            folder.when_last_row().assert_eq(
                folder.main_local[main_width - 14 + i], g[i]
            )
    sends, receives = _local(sends), _local(receives)
    n_lookups = len(sends) + len(receives)
    width = perm_trace_width(n_lookups, batch_size)
    if width == 0:
        return
    perm_local, perm_next = folder.perm_columns(width)
    alpha, beta = folder.perm_challenges

    # folders may expose pre-reduced beta powers (beta_power(j) -> beta^(j+1));
    # the circuit folder does, so rlc chains don't re-pay emulated-field
    # reductions per value (host numeric folders use the plain chain)
    beta_power = getattr(folder, "beta_power", None)
    for entry, chunk in zip(perm_local[: width - 1], _chunks(sends, receives, batch_size)):
        rlcs = []
        mults = []
        for lookup, is_send in chunk:
            rlc = alpha + int(lookup.kind)
            if beta_power is not None:
                for j, v in enumerate(lookup.values):
                    rlc = rlc + beta_power(j) * v
            else:
                bpow = beta
                for v in lookup.values:
                    rlc = rlc + bpow * v
                    bpow = bpow * beta
            rlcs.append(rlc)
            mults.append(lookup.multiplicity if is_send else -lookup.multiplicity)
        product = rlcs[0]
        for r in rlcs[1:]:
            product = product * r
        numerator = None
        for i, m in enumerate(mults):
            term = m
            for j, r in enumerate(rlcs):
                if j != i:
                    term = term * r
            numerator = term if numerator is None else numerator + term
        folder.assert_eq_ext(product * entry, numerator)

    sum_local = perm_local[0]
    sum_next = perm_next[0]
    for c in perm_local[1 : width - 1]:
        sum_local = sum_local + c
    for c in perm_next[1 : width - 1]:
        sum_next = sum_next + c
    phi_local = perm_local[-1]
    phi_next = perm_next[-1]
    folder.when_first_row().assert_eq_ext(phi_local, sum_local)
    folder.when_transition().assert_eq_ext(phi_next - phi_local, sum_next)
    folder.when_last_row().assert_eq_ext(phi_local, folder.local_cumulative_sum)


def count_permutation_constraints(num_lookups: int, batch_size: int = 2) -> int:
    if num_lookups == 0:
        return 0
    return (perm_trace_width(num_lookups, batch_size) - 1) + 3
