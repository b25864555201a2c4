"""End-to-end walkthrough: execute, prove, verify, and compress a guest ELF.

    python -m ziren_tpu_torch.examples.prove_guest path/to/guest.elf [--compress]
        [--device cpu|host|cuda:K]

The path is required: the repository holds no guest ELF
(`chip_smoke.minimal_elf()` writes a sixteen-word one). Dev config; the
guest reads the word 10 from its stdin. The prover runs on the GPU unless
--device names the CPU (the kernels' plain versions) or the host numpy
prover; without a card and without --device it fails.
"""

from __future__ import annotations

import argparse
import time

from ..device import prover_device
from ..sdk import ProverClient, ZirenStdin
from ..stark.proof import MachineProof
from ..stark.verifier import VerificationError


def main(elf_path, compress=False, device=None):
    device = prover_device(device)
    with open(elf_path, "rb") as f:
        elf = f.read()
    client = ProverClient(config="dev", device=device)
    stdin = ZirenStdin().write_u32s([10])

    pv, report = client.execute(elf, stdin)
    print(f"executed: {report.total_instruction_count} cycles, "
          f"exit {report.exit_code}")
    if report.stdout:
        print("stdout:", report.stdout.decode("utf-8", "replace"))

    pk, vk = client.setup(elf)
    t0 = time.perf_counter()
    proof = client.prove(pk, stdin)
    print(f"proved in {time.perf_counter() - t0:.1f}s "
          f"({len(proof.proof.shard_proofs)} shard(s))")
    if not client.verify(proof, vk):
        raise VerificationError("the guest's proof does not verify")
    print("verified", flush=True)

    if compress:
        t0 = time.perf_counter()
        rm, rvk, final_sp = client.compressed_prove(pk, stdin)
        if not rm.verify(rvk, MachineProof([final_sp])):
            raise VerificationError("the compressed proof does not verify")
        print(f"compressed to ONE recursion proof in "
              f"{time.perf_counter() - t0:.0f}s and verified", flush=True)
    return proof


def cli(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ziren_tpu_torch.examples.prove_guest")
    ap.add_argument("elf_path", metavar="path/to/guest.elf")
    ap.add_argument("--compress", action="store_true",
                    help="also compress the shard proofs into one recursion proof")
    ap.add_argument("--device", default=None,
                    help="where the prover runs: the GPU when left out, cpu, or host")
    return main(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    cli()
