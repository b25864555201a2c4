"""StarkMachine: chip set + setup + machine-level prove/verify, and the
device prove of every shard of an execution (`prove`, also reached through
`StarkMachine.prove`).

(reference: crates/stark/src/machine.rs — setup commits preprocessed traces
into pk/vk; verify replays every shard with a cloned challenger and checks
the global septic digest sum; here the global digest check is wired once the
Global chip lands, the local cumulative-sum check is per shard.)
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import closing
from dataclasses import dataclass, field

import numpy as np

from ..device import Member, Mesh, to_host
from . import tfused
from .backend import resolve_device
from .chip import Chip
from .proof import MachineProof
from .prover import prove_shard
from .shape import fix_shape
from .tprover import dispatch_shard, finish, shard_traces
from .verifier import verify_shard, VerificationError
from ..trace import carried, span


@dataclass
class ProvingKey:
    commit: np.ndarray
    data: object  # pcs ProverData or None
    chip_ordering: dict  # chip name -> index in preprocessed batch
    chip_information: list  # (name, Domain, (h, w), local_only)
    preprocessed_by_name: dict  # name -> trace
    vk: "VerifyingKey"


@dataclass
class VerifyingKey:
    commit: np.ndarray
    chip_information: list  # (name, Domain, (h, w), local_only)
    extra_observations: list = field(default_factory=list)
    commit_kind: str = "kb"  # "kb" | "bn254" (outer/wrap config)

    def observe_into(self, ch):
        if self.commit_kind == "bn254":
            # outer config: the vk commit is ONE Fr digest; the multifield
            # challenger duplexes on demand, no rate padding convention
            ch.observe_fr(int(self.commit))
            for x in self.extra_observations:
                ch.observe(int(x))
            return
        ch.observe_slice(np.asarray(self.commit, np.uint32))
        for x in self.extra_observations:
            ch.observe(int(x))
        total = 8 + len(self.extra_observations)
        pad = (-total) % 8
        for _ in range(pad):
            ch.observe(0)


class StarkMachine:
    def __init__(self, config, airs, num_public_values=0):
        self.config = config
        self.chips = [Chip(a, num_public_values) for a in airs]
        self.chip_by_name = {c.name: c for c in self.chips}
        self.num_public_values = num_public_values

    def setup(self, program=None, extra_observations=None):
        pcs = self.config.pcs
        named = []
        for chip in self.chips:
            prep = chip.air.generate_preprocessed(program)
            if prep is not None:
                assert prep.shape[1] == chip.preprocessed_width, chip.name
                named.append((chip, np.asarray(prep, np.uint32)))
        named.sort(key=lambda t: -t[1].shape[0])
        if named:
            domains = [pcs.natural_domain_for_degree(t.shape[0]) for _, t in named]
            commit, data = pcs.commit(list(zip(domains, [t for _, t in named])))
            info = [
                (c.name, d, t.shape, c.local_only)
                for (c, t), d in zip(named, domains)
            ]
        elif getattr(self.config, "commit_kind", "kb") == "bn254":
            commit, data, info = 0, None, []  # zero Fr digest
        else:
            commit, data, info = np.zeros(8, dtype=np.uint32), None, []
        vk = VerifyingKey(
            commit, info, list(extra_observations or []),
            commit_kind=getattr(self.config, "commit_kind", "kb"),
        )
        pk = ProvingKey(
            commit=commit,
            data=data,
            chip_ordering={c.name: i for i, (c, _) in enumerate(named)},
            chip_information=info,
            preprocessed_by_name={c.name: t for c, t in named},
            vk=vk,
        )
        return pk, vk

    def prove(self, pk, records, fix_shapes: bool = False, device=None, devices=None,
              stats: dict | None = None) -> MachineProof:
        """Prove every shard. Shards are transcript-independent (each gets a
        clone of the post-vk challenger, reference prover.rs).

        `device` names where the shards are proved. None is the GPU and
        raises without one; a torch device ("cuda", "cuda:0", or "cpu" for
        the plain PyTorch versions of the kernels) runs the torch shard
        prover there: the shard loop of stark.machine.prove, below, which
        under ZIREN_FUSED=1 proves through one CUDA graph per shard shape
        (stark/tfused.py). "host" is the numpy oracle prover
        (stark/prover.py), whose shards prove concurrently in a thread pool
        (numpy and the native kernels release the GIL). A config that is not
        device_capable (the outer BN254 config) takes "host" only. `devices`
        (a device.Mesh, or a list of devices that becomes one) in place of
        `device` proves shard i on member i % len(devices); passing both
        raises.

        fix_shapes=True pads every shard to one batch-wide shape
        (stark/shape.py)."""
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        if not (isinstance(device, str) and device == "host"):
            if not getattr(self.config, "device_capable", True):
                raise ValueError(
                    "this config is host-only: pass device='host'"
                )
            return prove(self, pk, records, device=device, devices=devices,
                         fix_shapes=fix_shapes, stats=stats)

        if fix_shapes and len(records) > 1:
            fix_shape(self, records)
        base = self.config.challenger()
        pk.vk.observe_into(base)
        if len(records) <= 1:
            return MachineProof(
                [prove_shard(self, pk, r, base.clone()) for r in records]
            )
        workers = min(len(records), os.cpu_count() or 4)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futs = [
                pool.submit(carried(prove_shard), self, pk, r, base.clone())
                for r in records
            ]
            return MachineProof([f.result() for f in futs])

    def verify(self, vk, proof: MachineProof) -> bool:
        base = self.config.challenger()
        vk.observe_into(base)
        if not proof.shard_proofs:
            raise VerificationError("empty proof")
        for sp in proof.shard_proofs:
            ch = base.clone()
            verify_shard(self, vk, sp, ch)
        # global septic digest balance across shards
        # (reference: machine.rs:659-674)
        from ..core import septic as S

        digests = []
        for sp in proof.shard_proofs:
            for name, vals in zip(sp.chip_names, sp.opened_values):
                if self.chip_by_name[name].commit_scope.name == "Global":
                    g = vals.global_cumulative_sum
                    digests.append((g[:7], g[7:14]))
        if digests and not S.digests_balance(digests):
            raise VerificationError("global cumulative sum does not balance")
        return True


def prove(machine, pk, records, *, device=None, devices=None, fix_shapes: bool = True,
          stats: dict | None = None) -> MachineProof:
    """Prove every shard with the torch shard prover: the device branch of
    StarkMachine.prove, and its one shard loop.

    The loop runs over members: `device` is one (None is the GPU and raises
    without one; "cpu" runs the plain PyTorch versions of the kernels), and
    `devices` in place of it (a device.Mesh, or a list of devices that
    becomes one; passing both raises) is the data-parallel path of the JAX
    package's StarkMachine.prove(devices=...): shard i is proved on member
    i % len(devices), on that member's stream.

    Each shard's body is issued without waiting for the device: eagerly
    (tprover.dispatch_shard), or under ZIREN_FUSED=1 (tfused.enabled())
    through one CUDA graph per shard shape and member
    (tfused.dispatch_fused), every shard then padded to one shape.
    fix_shapes pads every shard to one batch-wide shape (stark/shape.py).
    When the cost model gives the targets without trace generation, shards
    generate their traces in a thread pool while earlier shards prove.
    Every shard's proof comes back in one device-to-host copy per member at
    the end, and is assembled on the host (tprover.finish).

    `stats`, when given, receives host wall seconds per phase: trace-gen
    waits and dispatches per shard (a dispatch issues the shard's device
    work, eager or replayed, without waiting for it), the fetch and the
    assembly; on a mesh the member of each shard; on the fused path the
    graphs this call built (capture and instantiate seconds, nodes, pool
    bytes, launches recorded) and the device milliseconds of each replay
    (CUDA events)."""
    if devices is not None:
        if device is not None:
            raise ValueError("pass device or devices, not both")
        mesh = devices if isinstance(devices, Mesh) else Mesh(devices, "shard")
        members = mesh.members
    else:
        mesh, members = None, (Member(None, resolve_device(device)),)
    fused = tfused.enabled()
    path = "sharded" if mesh is not None else "fused" if fused else "eager"
    with span("prove", shards=len(records), path=path):
        base = machine.config.challenger()
        pk.vk.observe_into(base)
        waits, dispatch_s, dispatches = [], [], []
        with closing(shard_traces(machine, records, fix_shapes or fused)) as pending:
            for i in range(len(records)):
                member = members[i % len(members)]
                with span("shard", index=i) as sp:
                    with span("trace_wait"):
                        r, wait = next(pending)
                    waits.append(wait)
                    t0 = time.perf_counter()
                    with member.scope():
                        if fused:
                            d = tfused.dispatch_fused(machine, pk, r, member)
                        else:
                            d = dispatch_shard(machine, pk, r, base.clone(), member.device)
                    dispatch_s.append(time.perf_counter() - t0)
                    dispatches.append((member, d))
                    sp.set(chips=len(d["chips"]), rows=max(t.size for t in d["trace_domains"]))
                    if mesh is not None:
                        sp.set(member=member.index)

        t0 = time.perf_counter()
        with span("fetch"):
            fetched = to_host([(member, d["fetch"]) for member, d in dispatches])
        t1 = time.perf_counter()
        proofs = []
        for (_member, d), got in zip(dispatches, fetched):
            with span("assemble"):
                proofs.append(finish(pk, d, got))
    if stats is not None:
        stats.update(trace_wait_s=waits, dispatch_s=dispatch_s, fetch_s=t1 - t0,
                     assemble_s=time.perf_counter() - t1)
        if mesh is not None:
            stats["member"] = [member.index for member, _d in dispatches]
        if fused:
            stats["built"] = [d["built"] for _m, d in dispatches if d["built"]]
            stats["replay_ms"] = [d["events"][0].elapsed_time(d["events"][1])
                                  for _m, d in dispatches if d["events"]]
    return MachineProof(proofs)
