"""Data-parallel shard proving over a mesh of members (counterpart of
stark/sharded.py).

`prove_shards_sharded` proves a batch of execution shards over a 1-D mesh
(ziren_tpu_torch/device.py): every member runs the complete shard prove
(commit, LogUp permutation, quotient, FRI open, Fiat-Shamir transcript and
proof-of-work) on its own shards, with no traffic between members (shards
are transcript-independent: each starts from a clone of the post-vk
challenger, reference crates/stark/src/prover.rs:676-688).

Shards must share one proof shape, as the JAX package's shard_map does, so
records first go through `fix_shape` (stark/shape.py). Then shard i goes to
member i % N. The JAX package's compiled whole-shard step is here one
stark/tfused._FusedShard per member and shape: the body is tprover.prove_body,
captured into a CUDA graph on that member's card and replayed on the
member's stream (on a CPU member the body runs over its buffers without
capture). Members on one card overlap their shards; members on distinct
cards prove in parallel. Proofs are bit-identical to the eager device path
and to the host prover on the same padded records.
"""

from __future__ import annotations

import time

from ..device import Mesh, to_host
from . import tfused, tprover
from .proof import MachineProof
from .shape import fix_shape
from ..trace import span


def prove_shards_sharded(machine, pk, records, mesh: Mesh | None = None, grid: int = 1,
                         stats: dict | None = None) -> MachineProof:
    """Prove `records` data-parallel over `mesh` (default: one member per
    visible card on a "shard" axis; it raises without CUDA). Returns the
    MachineProof in record order, after one device-to-host copy per member.

    `stats`, when given, receives the member of each shard, the host
    seconds of each shard's call (warm-up and capture, or load and replay),
    the graphs this call built (capture and instantiate seconds, nodes,
    pool bytes), and the fetch and assembly seconds."""
    if mesh is None:
        mesh = Mesh.default("shard")
    assert len(records) >= 1
    with span("prove", shards=len(records), path="sharded"):
        fix_shape(machine, records, grid)

        shards, call_s, built_now = [], [], []
        for i, record in enumerate(records):
            member = mesh[i % len(mesh)]
            with span("shard", index=i, member=member.index) as sp:
                chips, traces, trace_domains, public_values = tprover.shard_layout(machine, record)
                sp.set(chips=len(chips), rows=max(t.shape[0] for t in traces))
                t0 = time.perf_counter()
                with member.scope():
                    fs, built, fetch, _events = tfused.get_fused_fn(
                        machine, pk, chips, trace_domains, traces, public_values, member.device,
                        member)
                call_s.append(time.perf_counter() - t0)
            if built:
                built_now.append(fs)
            shards.append((member, fs, fetch, {"chips": chips, "trace_domains": trace_domains,
                                               "public_values": public_values,
                                               "fri": machine.config.fri}))

        t0 = time.perf_counter()
        with span("fetch"):
            fetched = to_host([(member, fetch) for member, _fs, fetch, _d in shards])
        t1 = time.perf_counter()
        proofs = []
        for (_member, fs, _fetch, d), got in zip(shards, fetched):
            d["meta"] = fs.meta
            with span("assemble"):
                proofs.append(tprover.finish(pk, d, got))
    if stats is not None:
        stats.update(
            member=[member.index for member, *_ in shards], call_s=call_s,
            fetch_s=t1 - t0, assemble_s=time.perf_counter() - t1,
            built=[{"capture_s": fs.capture_s, "instantiate_s": fs.instantiate_s,
                    "nodes": fs.nodes, "pool_bytes": fs.pool_bytes} for fs in built_now],
        )
    return MachineProof(proofs)
