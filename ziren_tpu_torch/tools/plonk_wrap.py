"""Full-scale Plonk wrap: ladder -> wrap R1CS -> Plonk prove + verify
(the reference's wrap_plonk_bn254 stage, tool-scale: the dev wrap circuit
converts to ~6.8M gates; setup + prove are SRS/MSM/NTT-bound and run for
tens of minutes).

    python -u -m ziren_tpu_torch.tools.plonk_wrap [fib_n] [--device cpu|host|cuda:K]

ProverClient(config="dev") proves fibonacci(fib_n), compresses and shrinks
it on the GPU unless --device names the CPU or the host numpy prover
(without a card and without --device it fails). The wrap and the SNARK stay
on the host: wrap_prove proves with the host prover, the only one the outer
BN254 config has, and the Plonk setup and prove are the native MSM/NTT.
"""

from __future__ import annotations

import argparse
import time

from ..device import prover_device
from ..executor.asm import fibonacci_program
from ..sdk import ProverClient, ZirenStdin
from ..stark.config import outer_dev_config
from ..stark.verifier import VerificationError


def main(n=30, device=None):
    device = prover_device(device)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:8.1f}s] {msg}", flush=True)

    client = ProverClient(config="dev", device=device)
    pk, vk = client.setup(fibonacci_program(n))
    compressed = client.compressed_prove(pk, ZirenStdin())
    log("compressed")
    shrunk = client.shrink_prove(compressed)
    log("shrunk")
    wrapped = client.wrap_prove(shrunk, outer=outer_dev_config())
    log("wrapped")
    artifact = client.plonk_prove(wrapped)
    log(f"plonk proved: {len(artifact['proof'])} proof bytes")
    if not client.plonk_verify(artifact):
        raise VerificationError("the Plonk proof does not verify")
    log("plonk verified")
    return artifact


def cli(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ziren_tpu_torch.tools.plonk_wrap")
    ap.add_argument("n", nargs="?", type=int, default=30, metavar="fib_n")
    ap.add_argument("--device", default=None,
                    help="where the STARK provers run: the GPU when left out, cpu, or host")
    return main(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    cli()
