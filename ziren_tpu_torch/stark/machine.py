"""The port's entry point: prove every shard of a MIPS execution on a device.

Counterpart of the device branch of ziren_tpu.stark.machine.StarkMachine.prove
(stark/machine.py:121-185). It takes the `machine` and `pk` that ziren_tpu
builds (`mips_machine(...)`, `machine.setup(program)`) and returns a
`MachineProof` that `machine.verify` / `verify_mips_proof` accept.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ziren_tpu.stark.proof import MachineProof
from ziren_tpu.stark.shape import estimate_targets, fix_shape, generate_fixed
from .backend import resolve_device
from .tprover import dispatch_shard, finish


def prove(machine, pk, records, *, device, fix_shapes: bool = True,
          stats: dict | None = None) -> MachineProof:
    """Prove every shard on `device` (a CUDA device, or the CPU for the
    plain versions of the kernels).

    fix_shapes pads every shard to one batch-wide shape (stark/shape.py).
    When the cost model gives the targets without trace generation, shards
    generate their traces in a thread pool while earlier shards prove.
    Every shard's proof comes back in one device-to-host copy at the end.

    `stats`, when given, receives host wall seconds per phase: trace-gen
    waits and dispatches per shard (a dispatch includes the device time up
    to its proof-of-work grind), the fetch and the assembly."""
    device = resolve_device(device)
    targets = None
    if fix_shapes and len(records) > 1:
        targets = estimate_targets(machine, records)
        if targets is None:
            fix_shape(machine, records)

    base = machine.config.challenger()
    pk.vk.observe_into(base)
    waits, dispatch_s, dispatches = [], [], []

    def run(r):
        t0 = time.perf_counter()
        dispatches.append(dispatch_shard(machine, pk, r, base.clone(), device))
        dispatch_s.append(time.perf_counter() - t0)

    if targets is not None:
        workers = min(len(records), os.cpu_count() or 4)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futs = [pool.submit(generate_fixed, machine, r, targets) for r in records]
            for fut, r in zip(futs, records):
                t0 = time.perf_counter()
                fut.result()
                waits.append(time.perf_counter() - t0)
                run(r)
    else:
        for r in records:
            run(r)

    t0 = time.perf_counter()
    flats = [d["fetch"] for d in dispatches]
    fetched = torch.cat(flats).cpu().numpy()
    t1 = time.perf_counter()
    proofs, off = [], 0
    for d, f in zip(dispatches, flats):
        proofs.append(finish(pk, d, fetched[off : off + f.numel()]))
        off += f.numel()
    if stats is not None:
        stats.update(trace_wait_s=waits, dispatch_s=dispatch_s, fetch_s=t1 - t0,
                     assemble_s=time.perf_counter() - t1)
    return MachineProof(proofs)
