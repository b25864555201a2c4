"""Stage-by-stage probe of the torch shard prover on the card, with
unbuffered timestamps.

    python -m ziren_tpu_torch.tools.device_probe [fib_n] [shard_size] [--device cpu|cuda:K]

Isolates where a cold shard's time goes: the upload of the traces, the
preprocessed commit (stark/tprover.py:device_pk), the main commit
(ops/tpcs.py:commit: LDE, leaf hashes and Merkle levels), then one
shard's dispatch, fetch and assembly; then a warm prove of every shard
(machine.prove, fix_shapes=True) and a warm shard's legs. fibonacci(fib_n)
at the core config in shards of shard_size cycles. A kernel launch
returns at once, so every stage is timed between two
torch.cuda.synchronize() calls: its wall time is its own. The traces are
uploaded as canonical int64 (no Montgomery form to convert to). The device
is the GPU when --device is left out (it fails without one) or the CPU (the
kernels' plain versions).
"""

from __future__ import annotations

import argparse
import time

from ..device import device_name, prover_device, synchronize
from ..executor.asm import fibonacci_program
from ..machine.mips import execute_sharded, mips_machine, verify_mips_proof
from ..ops import tfield as tf
from ..ops import tpcs
from ..stark import tprover
from ..stark.config import core_config
from ..stark.shape import estimate_targets, generate_fixed
from ..stark.verifier import VerificationError


def main(n=58218, shard_size=(1 << 16) - 64, device=None):
    device = prover_device(device, host=False)
    t_start = time.time()
    stages: dict = {}

    def log(msg):
        print(f"[{time.time() - t_start:8.1f}s] {msg}", flush=True)

    def staged(name, fn, *args):
        """fn(*args) between two synchronizes; its seconds under `name`."""
        synchronize(device)
        t0 = time.time()
        out = fn(*args)
        synchronize(device)
        stages[name] = time.time() - t0
        return out

    log(f"devices={device_name(device)}")
    program = fibonacci_program(n)
    machine = mips_machine(core_config())
    pk, vk = machine.setup(program, extra_observations=[program.pc_start])
    log("setup done")

    ex, records = execute_sharded(program, shard_size)
    log(f"exec done: {len(records)} shards, {ex.global_clk} cycles")
    targets = estimate_targets(machine, records)
    log(f"targets: {sorted(targets.items(), key=lambda kv: -kv[1])[:6]}...")
    traces = generate_fixed(machine, records[0], targets)
    log(f"trace gen shard0 done: {sum(t.nbytes for _, t in traces) >> 20} MB")

    tallest = sorted(traces, key=lambda t: -t[1].shape[0])
    mains = staged("upload", lambda: [tf.from_host(t, device) for _, t in tallest])
    log(f"upload done in {stages['upload']:.1f}s")

    fri = machine.config.fri
    pcs_host = machine.config.pcs
    doms = [pcs_host.natural_domain_for_degree(t.shape[0]) for _, t in tallest]

    staged("preprocessed_commit", tprover.device_pk, machine, pk, device)
    log(f"preprocessed commit done in {stages['preprocessed_commit']:.1f}s")

    staged("main_commit", tpcs.commit, list(zip(doms, mains)), fri.log_blowup)
    log(f"main commit done in {stages['main_commit']:.1f}s")

    # full dispatch+fetch for shard 0
    base = machine.config.challenger()
    pk.vk.observe_into(base)
    d = staged("dispatch", tprover.dispatch_shard, machine, pk, records[0], base.clone(),
               device)
    log(f"dispatch done in {stages['dispatch']:.1f}s")
    got = staged("fetch", tprover.fetch, [d], device)[0]
    log(f"fetch done in {stages['fetch']:.1f}s")
    first = staged("assemble", tprover.finish, pk, d, got)
    log("assembled")

    # warm repeat, all shards, pipelined path
    t0 = time.time()
    ex, records = execute_sharded(program, shard_size)
    t_exec = time.time() - t0
    proof = staged("warm_prove",
                   lambda: machine.prove(pk, records, fix_shapes=True, device=device))
    t_prove = stages["warm_prove"]
    stages["warm_exec"] = t_exec
    cycles = int(ex.global_clk)
    total = t_exec + t_prove
    log(f"WARM: exec {t_exec:.1f}s prove {t_prove:.1f}s "
        f"-> {cycles / total / 1e3:.1f} kHz ({len(records)} shards)")

    if not verify_mips_proof(machine, vk, proof, pc_start=program.pc_start):
        raise VerificationError("the warm prove's proof does not verify")
    log("verified")

    # warm single-shard attribution
    ex, records = execute_sharded(program, shard_size)
    staged("warm_gen", generate_fixed, machine, records[0], targets)
    d = staged("warm_dispatch", tprover.dispatch_shard, machine, pk, records[0],
               base.clone(), device)
    got = staged("warm_fetch", tprover.fetch, [d], device)[0]
    staged("warm_assemble", tprover.finish, pk, d, got)
    log(f"warm shard legs: gen {stages['warm_gen']:.2f}s dispatch "
        f"{stages['warm_dispatch']:.2f}s fetch {stages['warm_fetch']:.2f}s "
        f"assemble {stages['warm_assemble']:.2f}s")
    return {"stages": stages, "cycles": cycles, "program": program, "machine": machine,
            "vk": vk, "proof": proof, "first_shard": first}


def cli(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ziren_tpu_torch.tools.device_probe")
    ap.add_argument("n", nargs="?", type=int, default=58218)
    ap.add_argument("shard_size", nargs="?", type=int, default=(1 << 16) - 64)
    ap.add_argument("--device", default=None,
                    help="where the prover runs: the GPU when left out, or cpu")
    return main(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    cli()
