"""End-to-end proving benchmark through the port: cycles a second and the
proof's size.

    python -m ziren_tpu_torch.tools.bench_prove [n_iters] [config] [shard_size]
        [--elf PATH] [--device cpu|host|cuda:K]

Proves fibonacci(n_iters) (n_iters 0: the guest ELF that --elf names) at
the core or dev config with machine.mips.prove_program, one shard unless
shard_size is given, verifies it, and prints one JSON object: the cycles,
shards, prove and verify seconds, the serialized proof's bytes and
core_prove_khz (cycles over prove seconds). The prover runs on the GPU
unless --device names the CPU (the kernels' plain versions) or the host
numpy prover; without a card and without --device it fails.
"""

from __future__ import annotations

import argparse
import json
import time

from ..device import prover_device
from ..executor.asm import fibonacci_program
from ..executor.program import load_elf
from ..machine.mips import prove_program, verify_mips_proof
from ..stark.config import core_config, dev_config
from ..stark.serialize import serialize_machine_proof
from ..stark.verifier import VerificationError


def main(n=2000, config="core", shard_size=None, elf=None, device=None):
    device = prover_device(device)
    if n == 0:  # n=0 selects the guest ELF at `elf`
        if elf is None:
            raise ValueError("n=0 proves a guest ELF: pass its path as elf (--elf)")
        with open(elf, "rb") as f:
            program = load_elf(f.read())
    else:
        program = fibonacci_program(n)
    cfg = core_config() if config == "core" else dev_config()
    t0 = time.perf_counter()
    machine, pk, vk, proof, ex = prove_program(
        program, config=cfg, shard_size=shard_size, device=device
    )
    t_prove = time.perf_counter() - t0
    cycles = int(ex.global_clk)
    t0 = time.perf_counter()
    if not verify_mips_proof(machine, vk, proof, pc_start=program.pc_start):
        raise VerificationError("the proof does not verify")
    t_verify = time.perf_counter() - t0
    data = serialize_machine_proof(proof)
    print(
        json.dumps(
            {
                "metric": "core_prove_khz",
                "value": round(cycles / t_prove / 1000, 3),
                "unit": "kHz",
                "cycles": cycles,
                "shards": len(proof.shard_proofs),
                "prove_s": round(t_prove, 2),
                "verify_s": round(t_verify, 2),
                "proof_bytes": len(data),
                "config": config,
            }
        ),
        flush=True,
    )
    return proof


def cli(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ziren_tpu_torch.tools.bench_prove")
    ap.add_argument("n", nargs="?", type=int, default=2000)
    ap.add_argument("config", nargs="?", default="core", choices=["core", "dev"])
    ap.add_argument("shard_size", nargs="?", type=int, default=None)
    ap.add_argument("--elf", default=None, help="the guest ELF that n=0 proves")
    ap.add_argument("--device", default=None,
                    help="where the prover runs: the GPU when left out, cpu, or host")
    return main(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    cli()
