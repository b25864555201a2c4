"""The torch shard prover's legs, one after the other, on the card.

    python -m ziren_tpu_torch.tools.profile_device [fib_n] [shard_size]
        [--config dev|core] [--device cpu|cuda:K]

Legs reported (fibonacci(fib_n) in shards of shard_size cycles, dev config
unless --config core):
  exec      — native sharded execution
  est       — cost-model shape targets
  gen       — trace generation (all shards, serial here for attribution)
  dispatch  — host loop: layout + upload + issuing every shard's device
              work (stark/tprover.py:dispatch_shard; launches return at once)
  fetch     — one torch.cuda.synchronize() (the card's work drains) and
              the copy of every shard's fetch vector to the host
  assemble  — host proof assembly (tprover.finish)
then the same program through machine.prove(..., fix_shapes=True), where
trace generation runs in workers beside the card. A first shard is proved
before the timed legs: it builds the kernels and commits the preprocessed
traces. The legs are the torch prover's: the device is the GPU when
--device is left out (it fails without one) or the CPU (the kernels' plain
versions); the host numpy prover has no such legs.
"""

from __future__ import annotations

import argparse
import time

from ..device import device_name, prover_device, synchronize
from ..executor.asm import fibonacci_program
from ..machine.mips import execute_sharded, mips_machine, verify_mips_proof
from ..stark import tprover
from ..stark.config import core_config, dev_config
from ..stark.proof import MachineProof
from ..stark.shape import estimate_targets, generate_fixed
from ..stark.verifier import VerificationError


def main(n=58218, shard_size=(1 << 16) - 64, config="dev", device=None):
    device = prover_device(device, host=False)
    program = fibonacci_program(n)
    machine = mips_machine(core_config() if config == "core" else dev_config())
    pk, vk = machine.setup(program, extra_observations=[program.pc_start])
    print(f"backend=torch devices={device_name(device)}")

    t0 = time.perf_counter()
    ex, records = execute_sharded(program, shard_size)
    t_exec = time.perf_counter() - t0
    cycles = int(ex.global_clk)

    t0 = time.perf_counter()
    targets = estimate_targets(machine, records)
    t_est = time.perf_counter() - t0

    # warmup: build the kernels and commit the preprocessed traces on the
    # first shard (outside timing)
    generate_fixed(machine, records[0], targets)
    base = machine.config.challenger()
    pk.vk.observe_into(base)
    t0 = time.perf_counter()
    d = tprover.dispatch_shard(machine, pk, records[0], base.clone(), device)
    tprover.finish(pk, d, tprover.fetch([d], device)[0])
    t_warm = time.perf_counter() - t0
    print(f"exec={t_exec:.2f}s est={t_est:.2f}s warmup={t_warm:.2f}s "
          f"shards={len(records)} cycles={cycles}")

    # timed region, serial legs for attribution
    ex, records = execute_sharded(program, shard_size)
    t0 = time.perf_counter()
    for r in records:
        generate_fixed(machine, r, targets)
    t_gen = time.perf_counter() - t0

    synchronize(device)
    t0 = time.perf_counter()
    dispatches = [
        tprover.dispatch_shard(machine, pk, r, base.clone(), device) for r in records
    ]
    t_dispatch = time.perf_counter() - t0

    t0 = time.perf_counter()
    gots = tprover.fetch(dispatches, device)
    t_fetch = time.perf_counter() - t0

    t0 = time.perf_counter()
    proof = MachineProof(
        [tprover.finish(pk, dd, g) for dd, g in zip(dispatches, gots)]
    )
    t_assemble = time.perf_counter() - t0

    total = t_gen + t_dispatch + t_fetch + t_assemble + t_exec
    print(f"gen={t_gen:.2f}s dispatch={t_dispatch:.2f}s fetch={t_fetch:.2f}s "
          f"assemble={t_assemble:.2f}s")
    print(f"serial total={total:.2f}s -> {cycles / total / 1e3:.2f} kHz "
          f"(pipelined path overlaps gen+dispatch with device)")
    if not verify_mips_proof(machine, vk, proof, pc_start=program.pc_start):
        raise VerificationError("the serial legs' proof does not verify")
    print("verified")

    # the bench path (machine.prove: trace generation in workers, every
    # shard dispatched before the one fetch)
    ex, records = execute_sharded(program, shard_size)
    t0 = time.perf_counter()
    proof2 = machine.prove(pk, records, fix_shapes=True, device=device)
    t_prove = time.perf_counter() - t0
    print(f"machine.prove={t_prove:.2f}s -> "
          f"{cycles / (t_prove + t_exec) / 1e3:.2f} kHz", flush=True)
    return {"legs": {"exec": t_exec, "est": t_est, "warmup": t_warm, "gen": t_gen,
                     "dispatch": t_dispatch, "fetch": t_fetch, "assemble": t_assemble,
                     "serial_total": total, "machine.prove": t_prove},
            "cycles": cycles, "program": program, "machine": machine, "vk": vk,
            "proofs": (proof, proof2)}


def cli(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ziren_tpu_torch.tools.profile_device")
    ap.add_argument("n", nargs="?", type=int, default=58218)
    ap.add_argument("shard_size", nargs="?", type=int, default=(1 << 16) - 64)
    ap.add_argument("--config", default="dev", choices=["dev", "core"])
    ap.add_argument("--device", default=None,
                    help="where the prover runs: the GPU when left out, or cpu")
    return main(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    cli()
