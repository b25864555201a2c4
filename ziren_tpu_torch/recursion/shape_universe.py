"""Fixed shape universe + offline lift-vk enumeration
(reference: crates/core/machine/src/shape/mod.rs CoreShapeConfig clusters,
crates/prover/src/shapes.rs build_vk_map).

Motivation: the allowed-vk registry (recursion/vk_registry.py) must be a
STABLE constant for a given (guest, shard size, split opts) — two runs of
the same guest with different shard counts must agree on the root, or the
pinned-root trust anchor is meaningless. Two pieces deliver that:

  * **cluster shapes** — shards are padded to per-KIND cluster shapes
    (execution / execution+memory-endpoints / standalone-memory), each
    chip's height the kind-wide max rounded up to a log-height grid of 2.
    Interior execution shards of a long run are all "full", so the cluster
    vector is workload-count-invariant; the grid absorbs small drifts.
  * **phantom lift enumeration** — a lift's traced program depends only on
    the proof SHAPE, never its values, so a structural stand-in proof
    (zero commitments, zero openings, right dims everywhere) traced in
    phantom mode (recursion/dsl.py Tracer(phantom=True)) yields the exact
    recursion program + vk a real proof of that shape would. The registry
    is therefore enumerable BEFORE any proving — the reference's offline
    `build_vk_map`, minus the days of compute (no dummy proving runs).
"""

from __future__ import annotations

import os

import numpy as np

from ..stark.pcs import FriProof, QueryProof
from ..stark.proof import (
    AirOpenedValues,
    ChipOpenedValues,
    ShardCommitment,
    ShardProof,
)

GRID = 2  # log-height cluster grid (heights land on powers of 4)


def _round_log(log_h: int, grid: int = GRID) -> int:
    return ((log_h + grid - 1) // grid) * grid


def record_kind(record) -> str:
    """The shard's cluster kind (reference shape/mod.rs small/core/memory
    cluster split)."""
    has_mem = bool(record.mem_init) or bool(record.mem_final)
    if record.num_cycles == 0:
        return "memory"
    return "core+mem" if has_mem else "core"


def cluster_shapes(machine, records, grid: int = GRID) -> dict:
    """kind -> ordered shape tuple ((chip, log_height), tallest first,
    ties by machine chip order — the prover's trace ordering).

    Each chip's cluster height is the grid-rounded max over ALL records
    (not per kind): the full interior shards drive every cycle chip's
    height, so the vector does not move with the last shard's remainder —
    the property that keeps the registry root shard-count-invariant."""
    from ..stark.shape import emit_synthetic

    order = {c.name: i for i, c in enumerate(machine.chips)}
    global_tgt: dict = {}
    kind_chips: dict = {}
    for record in records:
        emit_synthetic(machine, record)
        kind = record_kind(record)
        chips = kind_chips.setdefault(kind, set())
        for c in machine.chips:
            if not c.air.included(record):
                continue
            chips.add(c.name)
            n = c.air.num_rows(record)
            assert n is not None, f"{c.name} lacks a num_rows cost model"
            log_h = (max(int(n), 4) - 1).bit_length()
            if c.preprocessed_width == 0:
                log_h = _round_log(log_h, grid)
            global_tgt[c.name] = max(global_tgt.get(c.name, 0), log_h)
    return {
        kind: tuple(
            sorted(
                ((n, global_tgt[n]) for n in chips),
                key=lambda kv: (-kv[1], order[kv[0]]),
            )
        )
        for kind, chips in kind_chips.items()
    }


def fix_records_to_clusters(machine, records, grid: int = GRID) -> dict:
    """Pad every record's traces to its kind's cluster shape (attached as
    record._fixed_traces, consumed by the provers). Returns the shapes."""
    from ..machine.layout import fixed_height
    from ..stark.shape import emit_synthetic

    shapes = cluster_shapes(machine, records, grid)
    for record in records:
        tgt = dict(shapes[record_kind(record)])
        chips = [c for c in machine.chips if c.air.included(record)]
        emit_synthetic(machine, record)
        if not getattr(record, "_deps_done", False):
            for c in chips:
                c.air.generate_dependencies(record, record)
            record._deps_done = True
        out = []
        for c in chips:
            with fixed_height(1 << tgt[c.name]):
                out.append((c, c.air.generate_trace(record, record)))
        record._fixed_traces = out
    return shapes


def phantom_shard_proof(machine, pk_or_vk, shape) -> ShardProof:
    """A structural ShardProof for `shape` ((chip_name, log_degree) tuples,
    tallest first): every value is zero, every dimension is exactly what
    the prover emits — sufficient for phantom-mode lift tracing."""
    vk = getattr(pk_or_vk, "vk", pk_or_vk)
    fri = machine.config.fri
    lb = fri.log_blowup
    chips = [machine.chip_by_name[n] for n, _ in shape]
    logs = [l for _, l in shape]
    z8 = np.zeros(8, np.uint32)
    e4 = lambda: np.zeros(4, np.uint32)

    opened = []
    for c, l in zip(chips, logs):
        prep_w = c.preprocessed_width
        prep = AirOpenedValues(
            local=[e4() for _ in range(prep_w)],
            next=[] if c.local_only else [e4() for _ in range(prep_w)],
        )
        main = AirOpenedValues(
            local=[e4() for _ in range(c.width)],
            next=[] if c.local_only else [e4() for _ in range(c.width)],
        )
        perm = AirOpenedValues(
            local=[e4() for _ in range(c.perm_width * 4)],
            next=[e4() for _ in range(c.perm_width * 4)],
        )
        quot = [[e4() for _ in range(4)] for _ in range(c.quotient_degree)]
        opened.append(ChipOpenedValues(
            preprocessed=prep, main=main, permutation=perm, quotient=quot,
            local_cumulative_sum=e4(),
            global_cumulative_sum=np.zeros(14, np.uint32),
            log_degree=l,
        ))

    # round structure mirrors prove_shard/pcs.open: [prep?, main, perm, quot]
    rounds_mats = []  # per round: [(lde_log, width)]
    if vk.chip_information:
        rounds_mats.append([
            (dims[0].bit_length() - 1 + lb, dims[1])
            for _n, _dom, dims, _lo in vk.chip_information
        ])
    rounds_mats.append([(l + lb, c.width) for c, l in zip(chips, logs)])
    rounds_mats.append(
        [(l + lb, c.perm_width * 4) for c, l in zip(chips, logs)]
    )
    quot_mats = []
    for c, l in zip(chips, logs):
        quot_mats += [(l + lb, 4)] * c.quotient_degree
    rounds_mats.append(quot_mats)

    log_max = max(h for mats in rounds_mats for h, _ in mats)
    n_layers = log_max - lb
    commits = [z8.copy() for _ in range(n_layers)]
    query_proofs = []
    for _ in range(fri.num_queries):
        input_openings = []
        for mats in rounds_mats:
            tree_log = max(h for h, _ in mats)
            rows = [np.zeros(w, np.uint32) for _h, w in mats]
            path = [z8.copy() for _ in range(tree_log)]
            input_openings.append((rows, path))
        cp_openings = []
        for i in range(n_layers):
            pair = np.zeros((2, 4), np.uint32)
            path = [z8.copy() for _ in range(log_max - i - 1)]
            cp_openings.append((pair, path))
        query_proofs.append(QueryProof(input_openings, cp_openings))

    return ShardProof(
        commitment=ShardCommitment(z8.copy(), z8.copy(), z8.copy()),
        opened_values=opened,
        opening_proof=FriProof(commits, query_proofs, e4(), 0),
        chip_names=[n for n, _ in shape],
        public_values=[0] * machine.num_public_values,
    )


def phantom_lift_vk(machine, vk, shape, config=None):
    """The lift (rec_machine, rec_vk) for a shape, enumerated WITHOUT any
    real proof (phantom tracing). Identical to the vk a real same-shape
    lift produces (tests/test_shape_universe.py proves the equivalence)."""
    from .mips_pipeline import lift_shard

    sp = phantom_shard_proof(machine, vk, shape)
    rm, rvk, _ = lift_shard(machine, vk, sp, config=config, phantom=True)
    return rm, rvk


def recursion_proof_shape(rm, rvk) -> tuple:
    """The ((chip, log_degree) tallest-first) shape a proof of this
    recursion machine will have — STATIC: every recursion chip is
    preprocessed (the program is straight-line SSA), so vk.chip_information
    already pins all heights; no witness or proving involved. Validated
    against real proofs in tests/test_vk_registry.py."""
    order = {c.name: i for i, c in enumerate(rm.chips)}
    entries = [
        (name, dims[0].bit_length() - 1)
        for name, _dom, dims, _lo in rvk.chip_information
    ]
    assert len(entries) == len(rm.chips), "non-preprocessed recursion chip"
    return tuple(sorted(entries, key=lambda kv: (-kv[1], order[kv[0]])))


FIXED_REGISTRY_HEIGHT = 64  # membership-path length baked into join programs


def _registry_cache_path(machine, vk, shapes, config, height) -> str:
    """Disk key for the enumerated registry (reference vk_map.bin,
    prover/src/lib.rs:228-240): a (machine, guest vk, shape universe,
    config) constant, plus the recursion-code version so any circuit edit
    invalidates it. The version is read from this package's own recursion
    sources, and the default directory is the package's build directory."""
    import hashlib
    import os

    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for rel in ("recursion/mips_pipeline.py", "recursion/pipeline.py",
                "recursion/verifier.py", "recursion/dsl.py",
                "recursion/machine.py", "recursion/vk_registry.py",
                "recursion/septic.py", "recursion/shape_universe.py"):
        p = os.path.join(base, rel)
        if os.path.exists(p):
            with open(p, "rb") as f:
                h.update(f.read())
    h.update(repr(sorted(tuple(s) for s in shapes)).encode())
    h.update(bytes(np.asarray(vk.commit, np.uint32)))
    fri = (config or machine.config).fri
    h.update(repr((fri.log_blowup, fri.num_queries, fri.proof_of_work_bits,
                   height)).encode())
    d = os.environ.get("ZIREN_VK_MAP_DIR",
                       os.path.join(base, "_build", "vk_map"))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, h.hexdigest()[:24] + ".vkmap")


def build_full_registry(machine, vk, shapes, config=None,
                        height: int = FIXED_REGISTRY_HEIGHT):
    """The COMPLETE allowed-vk registry: lift vks for every core shape PLUS
    the closure of join vks over them (reference build_vk_map enumerates
    compress shapes too — crates/prover/src/shapes.rs:33-90). Phantom
    tracing everywhere: no proving.

    Join closure: a join program depends only on its children's recursion
    STRUCTURE (machine shape + chip_information) — child vks are hinted and
    membership-checked in-circuit — so iterating joins over all known node
    structures reaches a fixed point (joins of equal-shaped children
    coincide). The registry height is FIXED so the membership-path length,
    which is baked into every join program, is a constant.

    Returns (VkRegistry, depth). The registry root is shard-count-invariant
    for a fixed shape universe: contents are the deduped, sorted vk set."""
    from .mips_pipeline import join
    from .vk_registry import VkRegistry

    if isinstance(shapes, dict):
        shapes = list(shapes.values())
    depth = (height - 1).bit_length()

    # vk_map.bin: the enumeration is a guest/config constant — load the
    # commit set from disk when the recursion code + universe are unchanged
    cache_path = _registry_cache_path(machine, vk, shapes, config, height)
    if os.path.exists(cache_path):
        blob = np.fromfile(cache_path, dtype=np.uint32).reshape(-1, 8)
        return VkRegistry(list(blob), height=height), depth

    nodes = {}  # struct signature -> (rm, rvk, phantom proof)
    for shape in shapes:
        rm, rvk = phantom_lift_vk(machine, vk, shape, config=config)
        rshape = recursion_proof_shape(rm, rvk)
        sp = phantom_shard_proof(rm, rvk, rshape)
        nodes.setdefault(_node_sig(rm, rvk, rshape), (rm, rvk, sp))

    vks = {np.asarray(rvk.commit, np.uint32).tobytes(): rvk.commit
           for _rm, rvk, _sp in nodes.values()}
    for _round in range(6):
        new_nodes = {}
        items = list(nodes.values())
        for a in items:
            for b in items:
                jm, jvk, _ = join(a[:3], b[:3], config=config, phantom=True,
                                  registry_depth=depth)
                jshape = recursion_proof_shape(jm, jvk)
                sig = _node_sig(jm, jvk, jshape)
                if sig not in nodes and sig not in new_nodes:
                    jsp = phantom_shard_proof(jm, jvk, jshape)
                    new_nodes[sig] = (jm, jvk, jsp)
                vks.setdefault(
                    np.asarray(jvk.commit, np.uint32).tobytes(), jvk.commit)
        if not new_nodes:
            break
        nodes.update(new_nodes)
    else:
        raise AssertionError("join shape closure did not converge")

    commits = [np.frombuffer(k, np.uint32) for k in sorted(vks)]
    assert len(commits) <= height, "registry overflow: raise the height"
    tmp = cache_path + f".tmp{os.getpid()}"
    np.concatenate(commits).astype(np.uint32).tofile(tmp)
    os.replace(tmp, cache_path)
    return VkRegistry(commits, height=height), depth


def _node_sig(rm, rvk, rshape):
    ci = tuple(
        (name, dom.log_n, tuple(dims), bool(local_only))
        for name, dom, dims, local_only in rvk.chip_information
    )
    return (rshape, ci, tuple(int(v) for v in rvk.commit))


def build_canonical_registry(machine, vk, shapes, config=None):
    """The allowed-vk registry over a shape universe (dict or iterable of
    shape tuples) — a machine/guest constant independent of any particular
    execution (reference build_vk_map). Since round 4 this is the FULL
    enumeration: lift vks AND the join closure over them
    (build_full_registry), so every vk in a compress tree — the final root
    vk included — is a registry member."""
    registry, _depth = build_full_registry(machine, vk, shapes,
                                           config=config)
    return registry
