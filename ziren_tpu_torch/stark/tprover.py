"""Device-resident shard prover on torch tensors (counterpart of
stark/jprover.py): the device runs commit -> permutation traces -> quotient
-> FRI open and the Fiat-Shamir transcript; the host runs the executor,
trace generation and the final proof assembly.

The transcript lives on the device (ops/tchallenger.py) and its buffer
structure is fixed by the proof's shape, so a shard is a stream of device
work with no host wait (the proof-of-work grind is K4) and one fetch of the
finished proof at the end. A shard is two parts: the host part
(`shard_layout`: traces, chip order, domains) and the device body
(`prove_body`), which reads only device tensors (the mains, the public
values, the post-vk transcript) and returns the fetch vector. The eager
path (`dispatch_shard`) and the CUDA graph of stark/tfused.py run the same
body. Proofs are bit-identical to stark/prover.py.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core import field as F
from ..device import synchronize
from .pcs import FriProof, QueryProof, TwoAdicFriPcs
from .proof import (
    AirOpenedValues,
    ChipOpenedValues,
    ShardCommitment,
    ShardProof,
)
from ..ops import tfield as tf
from ..ops import tpcs
from ..ops.tchallenger import TChallenger
from . import tfolder
from .shape import estimate_targets, fix_shape, generate_fixed

P = tf.P


# ---------------------------------------------------------------------------
# fetch: one device vector per shard, one copy to the host
# ---------------------------------------------------------------------------


def flatten_fetch(tree):
    """Concatenate every tensor leaf of a nested dict/list into ONE int64
    device vector. Returns (flat, (structure, shapes))."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            return ("d", [(k, walk(v)) for k, v in t.items()])
        if isinstance(t, (list, tuple)):
            return ("l", [walk(v) for v in t])
        leaves.append(t)
        return ("x", len(leaves) - 1)

    structure = walk(tree)
    shapes = [tuple(l.shape) for l in leaves]
    flat = torch.cat([l.reshape(-1) for l in leaves]) if leaves else None
    return flat, (structure, shapes)


def unflatten_fetch(flat_np, meta):
    """Host-side inverse of flatten_fetch over the fetched numpy vector."""
    structure, shapes = meta
    flat_np = np.asarray(flat_np)
    leaves = []
    off = 0
    for shp in shapes:
        size = int(np.prod(shp)) if shp else 1
        leaves.append(flat_np[off : off + size].reshape(shp))
        off += size

    def build(node):
        kind, body = node
        if kind == "d":
            return {k: build(v) for k, v in body}
        if kind == "l":
            return [build(v) for v in body]
        return leaves[body]

    return build(structure)


# ---------------------------------------------------------------------------
# preprocessed data
# ---------------------------------------------------------------------------


_PK_LOCK = threading.Lock()
# The device data of proving keys, (the preprocessed commit's prover data,
# the preprocessed traces on the device), by (key, device), the least
# recently used first. A key is held weakly: when it dies its entries go,
# and with them the device memory they hold. A live key evicted here is
# committed again on its next use. The bound is the most keys that one
# compress or one composition proves under, with room to spare: a compress
# proves under a lift key for each shard shape and a join key for each shape
# of pair in its tree, then shrink's key. Counted on the CPU: the compress of
# a two-shard fibonacci proof uses three keys (four with the shrink), that
# of the eight-shard proof of tests/test_torch_memory_split.py (five
# execution shards, three memory shards) seven (eight with the shrink), and
# chip_smoke.compose, a composition of two one-shard trees, six. A
# composition over the eight-shard tree adds the deferred leaf's and the
# attach's keys: ten. Twelve holds all of them, so that no key is evicted
# while its tree still proves under it.
_DEVICE_KEYS_MAX = 12
_DEVICE_KEYS: OrderedDict = OrderedDict()  # (id(pk), device) -> (weakref to pk, data)


def device_pk(machine, pk, device):
    """Device commit of the preprocessed traces, kept per (key, device) in
    the bounded table above; raises unless it reproduces the host
    pk.commit. Threads that prove under one pk at once (same-shaped
    recursion proofs share their keys) commit it once: the table fills
    under a lock."""
    with _PK_LOCK:
        return _device_pk(machine, pk, torch.device(device))


def device_keys() -> list:
    """The (key, device) pairs whose device data the table holds, the least
    recently used first."""
    with _PK_LOCK:
        return [(ref(), dev) for (_id, dev), (ref, _data) in _DEVICE_KEYS.items()]


def _device_pk(machine, pk, device):
    if pk.data is None:
        return None, {}
    slot = (id(pk), device)
    hit = _DEVICE_KEYS.get(slot)
    if hit is not None and hit[0]() is pk:
        _DEVICE_KEYS.move_to_end(slot)
        return hit[1]
    doms_mats = []
    prep_dev = {}
    for name, dom, _dims, _lo in pk.chip_information:
        m = tf.from_host(pk.preprocessed_by_name[name], device)
        prep_dev[name] = m
        doms_mats.append((dom, m))
    commit, data = tpcs.commit(doms_mats, machine.config.fri.log_blowup)
    if not np.array_equal(tf.to_host(commit), np.asarray(pk.commit, np.uint32)):
        raise RuntimeError("device preprocessed commit does not match host pk")
    # the callback runs when pk dies; it drops this entry if it is still here
    ref = weakref.ref(pk, lambda _ref, slot=slot: _DEVICE_KEYS.pop(slot, None))
    _DEVICE_KEYS[slot] = (ref, (data, prep_dev))
    _DEVICE_KEYS.move_to_end(slot)
    while len(_DEVICE_KEYS) > _DEVICE_KEYS_MAX:
        _DEVICE_KEYS.popitem(last=False)
    return data, prep_dev


# ---------------------------------------------------------------------------
# one shard
# ---------------------------------------------------------------------------


def shard_traces(machine, records, fix_shapes: bool):
    """Yield (record, seconds waited for its traces) in order, each record's
    traces generated. fix_shapes pads every shard to one batch-wide shape
    (stark/shape.py); when the cost model gives the targets without trace
    generation, shards generate their traces in a thread pool while the
    caller proves the earlier ones."""
    targets = None
    if fix_shapes and len(records) > 1:
        targets = estimate_targets(machine, records)
        if targets is None:
            fix_shape(machine, records)
    if targets is None:
        for r in records:
            yield r, 0.0
        return
    workers = min(len(records), os.cpu_count() or 4)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = [pool.submit(generate_fixed, machine, r, targets) for r in records]
        for fut, r in zip(futs, records):
            t0 = time.perf_counter()
            fut.result()
            yield r, time.perf_counter() - t0


def _named_traces(machine, record):
    named = getattr(record, "_fixed_traces", None)
    if named is not None:
        return list(named)
    chips = [c for c in machine.chips if c.air.included(record)]
    if not getattr(record, "_deps_done", False):
        for c in chips:
            c.air.emit_synthetic(record)
        for c in chips:
            c.air.generate_dependencies(record, record)
        try:
            record._deps_done = True
        except AttributeError:
            pass
    return [(c, c.air.generate_trace(record, record)) for c in chips]


def shard_layout(machine, record):
    """The host part of a shard: (chips tallest first, their host traces,
    their trace domains, the public values as ints). Everything but the
    traces' values and the public values is fixed by the shard's shape."""
    named_traces = _named_traces(machine, record)
    named_traces.sort(key=lambda t: -t[1].shape[0])
    chips = [c for c, _ in named_traces]
    traces = [t for _, t in named_traces]
    pcs_host = machine.config.pcs
    trace_domains = [pcs_host.natural_domain_for_degree(t.shape[0]) for t in traces]
    pv = record.public_values
    public_values = [int(v) for v in (pv.to_list() if hasattr(pv, "to_list") else pv)]
    return chips, traces, trace_domains, public_values


def pv_tensor(public_values, device) -> torch.Tensor:
    """The public values as a (k,) int64 device vector, words as given."""
    return torch.from_numpy(np.asarray(public_values, np.int64).reshape(-1)).to(device)


def dispatch_shard(machine, pk, record, challenger, device):
    """Issue every device operation of one shard's proof and return
    {"fetch": device vector, ...host metadata} without waiting for the
    device. `challenger` is the post-vk host challenger clone."""
    device = torch.device(device)
    chips, traces, trace_domains, public_values = shard_layout(machine, record)
    mains = [tf.from_host(t, device) for t in traces]
    pv = pv_tensor(public_values, device)
    ch = TChallenger.from_host(challenger, device)
    fetch, meta = prove_body(machine, pk, chips, trace_domains, mains, pv, ch)
    return {"fetch": fetch, "meta": meta, "chips": chips, "trace_domains": trace_domains,
            "public_values": public_values, "fri": machine.config.fri}


def prove_body(machine, pk, chips, trace_domains, mains, pv, ch):
    """The device body of a shard's proof. It reads only device tensors:
    `mains` (the traces in chip order), `pv` (the public values, (k,)) and
    the transcript `ch` (a TChallenger after the vk, which it advances).
    Its operations depend on the shape alone, and once the caches are warm
    (device_pk, the constant and index tensors, the selectors) it copies
    nothing from the host and never waits on the device. Returns (the fetch
    vector, {"fetch_meta", "rounds_meta", "has_prep"})."""
    device = pv.device
    fri = machine.config.fri
    log_blowup = fri.log_blowup

    prep_data, prep_dev = device_pk(machine, pk, device)
    main_commit, main_data = tpcs.commit(list(zip(trace_domains, mains)), log_blowup)

    ch.observe_vec(pv)
    ch.observe_vec(main_commit)
    alpha = ch.sample_ext()
    beta = ch.sample_ext()

    pv_folded = pv % P  # the transcript takes the words as given, the folders reduced
    perm_flats, cumsums = [], []
    for chip, main in zip(chips, mains):
        flat, cum = tfolder.perm_trace(
            chip, main, prep_dev.get(chip.name), pv_folded, alpha, beta
        )
        perm_flats.append(flat)
        cumsums.append(cum)
    perm_commit, perm_data = tpcs.commit(
        list(zip(trace_domains, perm_flats)), log_blowup
    )
    ch.observe_vec(perm_commit)

    # a Global chip's sum is the last row's last 14 columns of its trace
    global_sums = []
    for chip, main, cum in zip(chips, mains, cumsums):
        if chip.commit_scope.name == "Global":
            gsum = main[-1, -14:]
        else:
            gsum = torch.zeros(14, dtype=torch.int64, device=device)
        global_sums.append(gsum)
        ch.observe_vec(cum)
        ch.observe_vec(gsum)

    alpha_q = ch.sample_ext()

    quotient_domains = [
        d.create_disjoint_domain(1 << (d.log_n + c.log_quotient_degree))
        for d, c in zip(trace_domains, chips)
    ]
    # one shared alpha-power table; each chip uses its tail
    max_nc = max((c.num_constraints for c in chips), default=1)
    apows_all = tpcs.epowers_rev(alpha_q, max_nc)
    q_domains, q_chunks = [], []
    for i, (chip, tdom, qdom) in enumerate(zip(chips, trace_domains, quotient_domains)):
        assert chip.log_quotient_degree <= log_blowup
        qn = qdom.size
        prep_idx = pk.chip_ordering.get(chip.name)
        if prep_idx is not None:
            prep_q = tpcs.evals_on_domain(prep_data, prep_idx, qdom)
        else:
            prep_q = torch.zeros((qn, 0), dtype=torch.int64, device=device)
        sels = tfolder.selectors_on_coset(
            tdom.log_n, tdom.shift, qdom.log_n, qdom.shift, device
        )
        quotient = tfolder.quotient(
            chip,
            qn // tdom.size,
            prep_q,
            tpcs.evals_on_domain(main_data, i, qdom),
            tpcs.evals_on_domain(perm_data, i, qdom),
            sels,
            pv_folded,
            apows_all,
            (alpha, beta),
            cumsums[i],
            global_sums[i],
        )
        for j, sub_dom in enumerate(qdom.split_domains(chip.quotient_degree)):
            q_domains.append(sub_dom)
            q_chunks.append(quotient[j :: chip.quotient_degree])

    quotient_commit, quotient_data = tpcs.commit(
        list(zip(q_domains, q_chunks)), log_blowup
    )
    ch.observe_vec(quotient_commit)

    zeta = ch.sample_ext()

    # opening points, structurally tagged so equal points share work
    # (zeta * g computed once per domain size)
    next_pts: dict = {}

    def pts_for(dom, local_only):
        if local_only:
            return [("z", zeta)]
        if dom.log_n not in next_pts:
            next_pts[dom.log_n] = tpcs.next_point(zeta, dom)
        return [("z", zeta), (("zn", dom.log_n), next_pts[dom.log_n])]

    prep_points = [
        pts_for(dom, local_only) for _name, dom, _dims, local_only in pk.chip_information
    ]
    main_points = [pts_for(d, c.local_only) for c, d in zip(chips, trace_domains)]
    perm_points = [pts_for(d, False) for d in trace_domains]
    quotient_points = [[("z", zeta)] for _ in q_chunks]

    open_rounds = []
    if prep_data is not None:
        open_rounds.append((prep_data, prep_points))
    open_rounds += [
        (main_data, main_points),
        (perm_data, perm_points),
        (quotient_data, quotient_points),
    ]
    dev_out = dev_open(fri, log_blowup, open_rounds, ch)

    to_fetch = {
        "main": main_commit,
        "perm": perm_commit,
        "quot": quotient_commit,
        "cumsums": list(cumsums),
        "gsums": global_sums,
        "opened": dev_out["opened_cat"],
        "fri_commits": list(dev_out["layer_roots"]),
        "final": dev_out["final"],
        "pow": dev_out["pow_witness"],
        "round_rows": [list(rows) for rows in dev_out["round_rows"]],
        "round_paths": list(dev_out["round_paths"]),
        "layer_pairs": list(dev_out["layer_pairs"]),
        "layer_paths": list(dev_out["layer_paths"]),
    }
    rounds_meta = [
        [(data.widths[i], len(pts)) for i, pts in enumerate(points)]
        for data, points in open_rounds
    ]
    fetch_flat, fetch_meta = flatten_fetch(to_fetch)
    return fetch_flat, {"fetch_meta": fetch_meta, "rounds_meta": rounds_meta,
                        "has_prep": prep_data is not None}


def finish(pk, d, got) -> ShardProof:
    """Host assembly from a dispatched shard's fetched flat vector."""
    meta = d["meta"]
    tree = unflatten_fetch(got, meta["fetch_meta"])
    assert int(tree["pow"]) < P, "no proof-of-work witness below p"
    return assemble_proof(
        pk, d["chips"], d["trace_domains"], meta["rounds_meta"], d["fri"], tree,
        d["public_values"], [np.asarray(g, np.uint32) for g in tree["gsums"]],
        has_prep=meta["has_prep"],
    )


def fetch(dispatches, device) -> list:
    """Every dispatched shard's fetch vector on the host, after one wait for
    the device (the legs that stark/machine.py's prove runs as one)."""
    synchronize(device)
    return [d["fetch"].cpu().numpy() for d in dispatches]


def prove_shard(machine, pk, record, challenger, device) -> ShardProof:
    """Device counterpart of stark.prover.prove_shard."""
    d = dispatch_shard(machine, pk, record, challenger, device)
    return finish(pk, d, d["fetch"].cpu().numpy())


def assemble_proof(
    pk, chips, trace_domains, rounds_meta, fri, got,
    public_values, global_sums, has_prep,
):
    """Host assembly of a ShardProof from the fetched pytree `got` (a copy
    of jprover.assemble_proof, which cannot be imported without JAX).

    rounds_meta: per opening round, [(width, n_points)] per matrix -- the
    static structure that splits the one concatenated opened-values block."""
    u32 = lambda x: np.asarray(x, np.uint32)

    final_host = u32(got["final"])
    final = final_host[0].copy()
    assert np.all(final_host == final), "final polynomial is not constant"

    query_proofs = []
    for q in range(fri.num_queries):
        input_openings = []
        for r_i in range(len(rounds_meta)):
            rows = [u32(m[q]) for m in got["round_rows"][r_i]]
            path = [
                u32(got["round_paths"][r_i][q, j])
                for j in range(got["round_paths"][r_i].shape[1])
            ]
            input_openings.append((rows, path))
        cp_openings = []
        for l_i in range(len(got["layer_pairs"])):
            pair = u32(got["layer_pairs"][l_i][q]).reshape(2, 4)
            path = [
                u32(got["layer_paths"][l_i][q, j])
                for j in range(got["layer_paths"][l_i].shape[1])
            ]
            cp_openings.append((pair, path))
        query_proofs.append(QueryProof(input_openings, cp_openings))

    fri_proof = FriProof(
        [u32(r) for r in got["fri_commits"]],
        query_proofs,
        final,
        int(got["pow"]),
    )

    # split the one fetched (sum_w, 4) block back into per-(mat, point) rows
    opened_cat = u32(got["opened"])
    opened = []
    off = 0
    for metas in rounds_meta:
        round_vals = []
        for w, n_pts in metas:
            mat_vals = []
            for _ in range(n_pts):
                mat_vals.append(opened_cat[off : off + w])
                off += w
            round_vals.append(mat_vals)
        opened.append(round_vals)
    if has_prep:
        prep_vals, main_vals, perm_vals, quot_vals = opened
    else:
        main_vals, perm_vals, quot_vals = opened
        prep_vals = []

    cumsums = [u32(c) for c in got["cumsums"]]
    opened_chips = []
    q_off = 0
    for i, chip in enumerate(chips):
        prep_idx = pk.chip_ordering.get(chip.name)
        if prep_idx is not None:
            pv_ = prep_vals[prep_idx]
            prep_open = AirOpenedValues(
                local=list(pv_[0]), next=list(pv_[1]) if len(pv_) > 1 else []
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
        q = chip.quotient_degree
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
        commitment=ShardCommitment(
            u32(got["main"]), u32(got["perm"]), u32(got["quot"])
        ),
        opened_values=opened_chips,
        opening_proof=fri_proof,
        chip_names=[c.name for c in chips],
        public_values=public_values,
    )


# ---------------------------------------------------------------------------
# open (mirror of pcs.TwoAdicFriPcs.open)
# ---------------------------------------------------------------------------


def dev_open(fri, log_blowup, rounds, ch):
    """rounds: [(DevProverData, [[(tag, point) ...] per matrix])].
    Returns a dict of device tensors, the pow witness among them."""
    alpha = ch.sample_ext()

    # dedupe evaluation points by structural tag (zeta / zeta*g_logn)
    upoints: dict = {}
    upoint_vals: list = []

    def pid(tag, val):
        if tag not in upoints:
            upoints[tag] = len(upoint_vals)
            upoint_vals.append(val)
        return upoints[tag]

    sig = []
    for r, (data, points_per_mat) in enumerate(rounds):
        for i, pts in enumerate(points_per_mat):
            dom = data.domains[i]
            sig.append(
                (r, i, dom.log_n, dom.log_n + log_blowup, data.widths[i],
                 tuple(pid(t, v) for t, v in pts))
            )
    upts = torch.stack(upoint_vals)  # (U, 4)

    opened_cat, ro_vals, ro_keys = _open_stage_grouped(
        rounds, sig, upts, alpha, log_blowup
    )
    inputs = list(zip(ro_keys, ro_vals))  # tallest first
    log_max = inputs[0][0]
    layer_roots, trees, final, pow_witness, idxs = _fri_phase(
        ch, inputs, log_blowup, fri.proof_of_work_bits, fri.num_queries
    )

    round_rows, round_paths = [], []
    for data, _pts in rounds:
        rows, paths = tpcs.gather_tree_openings(data.tree, idxs, log_max)
        round_rows.append(rows)
        round_paths.append(paths)
    layer_pairs, layer_paths = [], []
    ii = idxs
    for tree in trees:
        rows, paths = tpcs.gather_tree_openings(
            tree, ii >> 1, int(tree.levels[0].shape[0]).bit_length() - 1
        )
        layer_pairs.append(rows[0])
        layer_paths.append(paths)
        ii = ii >> 1

    return {
        "opened_cat": opened_cat,
        "layer_roots": layer_roots,
        "final": final,
        "pow_witness": pow_witness,
        "round_rows": round_rows,
        "round_paths": round_paths,
        "layer_pairs": layer_pairs,
        "layer_paths": layer_paths,
    }


def _open_stage_grouped(rounds, sig, upts, alpha, log_blowup):
    """Opened values and reduced openings, one column contraction and one
    `_ro_step` per (round, commit group, point) over the height-concatenated
    matrices the commit already produced.

    The transcript semantics are those of the host pcs.open: alpha-power
    offsets are assigned in (round, matrix, point) order through a gathered
    power matrix (zero rows for matrices that do not open at a point), and
    the opened block is put back in per-(matrix, point) order by one row
    gather. sig: (round, mat, log_n, lde_log, width, point ids) per matrix."""
    dev = upts.device
    ro_keys = tuple(sorted({e[3] for e in sig}, reverse=True))
    total_w = sum(e[4] * len(e[5]) for e in sig) + 8
    apows = tpcs.zpow_table(alpha, max(total_w.bit_length(), 1))
    # one zero row appended: members not opening at a point gather it
    apows_z = torch.cat([apows, torch.zeros((1, 4), dtype=torch.int64, device=dev)])
    zero_row = apows_z.shape[0] - 1

    # alpha offsets in the original (round, matrix, point) order
    cnt = {l: 0 for l in ro_keys}
    ap_off = {}
    for r, i, _log_n, lde_log, w, pids in sig:
        for u in pids:
            ap_off[(r, i, u)] = cnt[lde_log]
            cnt[lde_log] += w

    sig_by_mat = {(e[0], e[1]): e for e in sig}
    zt: dict = {}
    inv_t: dict = {}
    ro = {l: None for l in ro_keys}
    grouped_blocks = []
    block_index = {}  # (round, group, point) -> index into grouped_blocks
    for r, (data, _pts) in enumerate(rounds):
        for g, members in enumerate(data.group_members):
            log_n = data.domains[members[0][0]].log_n
            lde_log = log_n + log_blowup
            pids_u = []  # union of the group's point ids, first-seen order
            for i, _w in members:
                for u in sig_by_mat[(r, i)][5]:
                    if u not in pids_u:
                        pids_u.append(u)
            gcoeff = data.group_coeffs[g]
            glde = data.group_ldes[g]
            W = gcoeff.shape[1]
            for u in pids_u:
                zk = (u, log_n)
                if zk not in zt:
                    zt[zk] = tpcs.zpow_table(upts[u], log_n)
                ys = tpcs.colwise_ext_contract(gcoeff, zt[zk])
                block_index[(r, g, u)] = len(grouped_blocks)
                grouped_blocks.append(ys)
                ik = (lde_log, u)
                if ik not in inv_t:
                    inv_t[ik] = _inv_z_minus_x(upts[u], lde_log)
                idx = np.full(W, zero_row, np.int64)
                off = 0
                for i, w in members:
                    if u in sig_by_mat[(r, i)][5]:
                        base = ap_off[(r, i, u)]
                        idx[off : off + w] = np.arange(base, base + w)
                    off += w
                ap = apows_z[tf.index(idx, dev)]
                acc = _ro_step(glde, ap, ys, inv_t[ik])
                ro[lde_log] = acc if ro[lde_log] is None else tf.madd(ro[lde_log], acc)

    # restore per-(matrix, point) order with one row gather
    block_starts = np.cumsum([0] + [int(b.shape[0]) for b in grouped_blocks])
    perm = np.empty(sum(e[4] * len(e[5]) for e in sig), np.int64)
    out = 0
    for r, i, _log_n, _lde_log, w, pids in sig:
        g, col = rounds[r][0].group_of[i]
        for u in pids:
            start = block_starts[block_index[(r, g, u)]] + col
            perm[out : out + w] = np.arange(start, start + w)
            out += w
    if grouped_blocks:
        grouped_cat = torch.cat(grouped_blocks)
    else:
        grouped_cat = torch.zeros((0, 4), dtype=torch.int64, device=dev)
    opened_cat = grouped_cat[tf.index(perm, dev)]

    ro_vals = tuple(
        ro[l] if ro[l] is not None
        else torch.zeros((1 << l, 4), dtype=torch.int64, device=dev)
        for l in ro_keys
    )
    return opened_cat, ro_vals, ro_keys


def _ro_step(lde, ap, ys, inv_t):
    """One (group, point) reduced-opening contribution:
    (alpha-combined ys - alpha-combined lde row) * (z - x)^-1."""
    y_term = tf.emul(ap, ys).sum(0) % P
    m_term = tpcs.mat_ext_matmul(lde, ap)
    return tf.emul((y_term - m_term) % P, inv_t)


def _inv_z_minus_x(z, l: int):
    """(2^l, 4) inverse of (z - x) over GENERATOR * H_l, natural order."""
    xs = (tpcs.powers_dev(F.two_adic_generator(l), 1 << l, z.device)
          * (F.GENERATOR % P)) % P
    return tf.einv((z - tf.efrom_base(xs)) % P)


def _fri_phase(ch, inputs, log_blowup: int, pow_bits: int, num_queries: int):
    """The FRI commit phase: bit-reverse the reduced openings (tallest
    first); per layer Merkle-commit the row pairs, observe the root, sample
    beta, fold, and add the next reduced opening at its height; then observe
    the final polynomial, grind, and sample the query indices."""
    log_max = inputs[0][0]
    shifts = TwoAdicFriPcs._make_shifts(log_max)
    it = iter(inputs)
    l, cur = next(it)
    cur = cur[tpcs.bitrev_idx(l, cur.device)]
    nxt = next(it, None)
    layer_roots, trees = [], []
    while cur.shape[0] > (1 << log_blowup):
        tree = tpcs.merkle_commit([cur.reshape(-1, 8)])
        layer_roots.append(tree.root)
        trees.append(tree)
        ch.observe_vec(tree.root)
        beta = ch.sample_ext()
        cur = tpcs.fri_fold(cur, beta, l, shifts[l])
        l -= 1
        if nxt is not None and nxt[0] == l:
            cur = tf.madd(cur, nxt[1][tpcs.bitrev_idx(l, cur.device)])
            nxt = next(it, None)
    # the final polynomial is a constant: observe its coefficient (row 0);
    # assemble_proof checks that all rows agree
    ch.observe_vec(cur[0])
    pow_witness = ch.grind(pow_bits)
    idxs = torch.stack([ch.sample_bits(log_max) for _ in range(num_queries)])
    return layer_roots, trees, cur, pow_witness, idxs
