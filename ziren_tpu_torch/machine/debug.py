"""Debug oracles: row-wise constraint checking and lookup multiset balance
(reference: crates/stark/src/debug.rs, lookup/debug.rs)."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..core import ext as E
from ..core import field as F
from ..stark.folder import DebugFolder, TraceFolder
from ..stark.permutation import generate_permutation_trace


def generate_all_traces(machine, pk, record):
    from ..stark.shape import record_traces

    return record_traces(machine, record)


def debug_constraints(machine, pk, record, challenges=None):
    """Raises AssertionError naming the chip/constraint on first violation."""
    rng = np.random.default_rng(42)
    if challenges is None:
        challenges = (
            rng.integers(0, F.P_INT, 4, dtype=np.uint32),
            rng.integers(0, F.P_INT, 4, dtype=np.uint32),
        )
    pv = record.public_values
    pv_list = pv.to_list() if hasattr(pv, "to_list") else list(pv)
    for chip, trace in generate_all_traces(machine, pk, record):
        prep = pk.preprocessed_by_name.get(chip.name)
        fl = TraceFolder(prep, trace, pv_list)
        chip.air.eval(fl)
        perm, cumsum = generate_permutation_trace(
            fl.sends, fl.receives, trace.shape[0], challenges, chip.batch_size
        )
        perm_flat = perm.reshape(trace.shape[0], -1, 4).reshape(trace.shape[0], -1)
        gsum = (
            trace[-1, -14:]
            if chip.commit_scope.name == "Global"
            else np.zeros(14, dtype=np.uint32)
        )
        dbg = DebugFolder(
            chip.name,
            prep,
            trace,
            pv_list,
            challenges,
            cumsum,
            perm=None,
            global_cumulative_sum=gsum,
        )
        if chip.perm_width:
            n = trace.shape[0]
            pl = [perm[:, c] for c in range(perm.shape[1])]
            pn = [np.roll(perm, -1, axis=0)[:, c] for c in range(perm.shape[1])]
            dbg._perm_local = [dbg.lift_ext(c) for c in pl]
            dbg._perm_next = [dbg.lift_ext(c) for c in pn]
        chip.eval_with_perm(dbg)
    return True


def debug_lookups(machine, pk, record):
    """Checks multiset balance of all local lookups across chips.

    Returns {} when balanced, else {(kind, values): net_multiplicity}.
    """
    pv = record.public_values
    pv_list = pv.to_list() if hasattr(pv, "to_list") else list(pv)
    acc = defaultdict(int)
    origin = defaultdict(list)
    for chip, trace in generate_all_traces(machine, pk, record):
        prep = pk.preprocessed_by_name.get(chip.name)
        fl = TraceFolder(prep, trace, pv_list)
        chip.air.eval(fl)
        n = trace.shape[0]
        for lookup, sign in [(l, 1) for l in fl.sends] + [
            (l, -1) for l in fl.receives
        ]:
            mult = np.broadcast_to(
                np.asarray(lookup.multiplicity.a, dtype=np.int64), (n,)
            )
            vals = np.stack(
                [
                    np.broadcast_to(np.asarray(v.a, dtype=np.int64), (n,))
                    for v in lookup.values
                ],
                axis=1,
            )
            nz = np.nonzero(mult)[0]
            for r in nz:
                key = (int(lookup.kind), tuple(int(x) for x in vals[r]))
                acc[key] += sign * int(mult[r])
                if acc[key] == 0:
                    del acc[key]
                else:
                    origin[key].append((chip.name, sign, r))
    return {k: v for k, v in acc.items() if v % F.P_INT != 0}, origin
