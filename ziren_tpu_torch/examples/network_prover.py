"""Remote proving over the signed twirp-shaped RPC (reference: the
crates/cuda GPU-prover container + sdk network prover, with HMAC-signed
jobs per sdk/src/network/prover.rs).

    python -m ziren_tpu_torch.examples.network_prover [--device cpu|host|cuda:K]

Starts an in-process ProverServer with a shared key, points a NetworkProver
at it, proves a fibonacci guest remotely and re-verifies LOCALLY (the
remote prover is untrusted for soundness). The server proves on the GPU
unless --device names the CPU or the host numpy prover; without a card and
without --device it fails before the server starts.
"""

from __future__ import annotations

import argparse

from ..device import prover_device
from ..executor.asm import fibonacci_program
from ..network import NetworkProver, ProverServer


def main(device=None):
    device = prover_device(device)
    key = "5e" * 32
    with ProverServer(config="dev", key=key, device=device) as srv:
        print(f"prover service: {srv.endpoint} (HMAC-signed requests)")
        prover = NetworkProver(srv.endpoint, config="dev", key=key)
        if not prover.ready():
            raise RuntimeError(f"the prover service at {srv.endpoint} is not ready")

        program = fibonacci_program(200)
        pk, vk = prover.setup(program)
        print(f"registered program id {pk.program_id[:16]}...")

        proof = prover.prove(pk)  # verified locally against the local vk
        print(f"proved remotely: {len(proof.proof.shard_proofs)} shard(s), "
              "verified locally - ok", flush=True)
    return proof


def cli(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ziren_tpu_torch.examples.network_prover")
    ap.add_argument("--device", default=None,
                    help="where the server proves: the GPU when left out, cpu, or host")
    return main(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    cli()
