"""Precompile showcase: execute AND prove guests that use the accelerated
syscalls (reference examples/{sha2,keccak,...}; the asm programs stand in
for Rust guests since no MIPS toolchain ships in this environment).

    python -m ziren_tpu_torch.examples.precompiles [keccak|sha256|poseidon2|secp256k1]
        [--core] [--device cpu|host|cuda:K]

Dev config unless --core. The prover runs on the GPU unless --device names
the CPU (the kernels' plain versions) or the host numpy prover; without a
card and without --device it fails.
"""

from __future__ import annotations

import argparse
import time

from ..device import prover_device
from ..executor import asm
from ..machine.mips import prove_program, verify_mips_proof
from ..stark.config import core_config, dev_config
from ..stark.verifier import VerificationError

PROGRAMS = {
    "keccak": lambda: asm.keccak_program(b"ziren-tpu precompile demo"),
    "sha256": asm.sha256_program,
    "poseidon2": asm.poseidon2_program,
    "secp256k1": lambda: asm.secp256k1_program("add"),
}


def main(which="keccak", core=False, device=None):
    device = prover_device(device)
    program = PROGRAMS[which]()
    cfg = core_config() if core else dev_config()
    t0 = time.time()
    machine, pk, vk, proof, ex = prove_program(program, config=cfg, device=device)
    dt = time.time() - t0
    names = {n for sp in proof.shard_proofs for n in sp.chip_names}
    print(f"{which}: {ex.global_clk} cycles proved+verified in {dt:.1f} s")
    print(f"precompile chips in the proof: "
          f"{sorted(n for n in names if n not in ('Cpu', 'Program', 'Byte'))}")
    if not verify_mips_proof(machine, vk, proof, pc_start=program.pc_start):
        raise VerificationError(f"the {which} proof does not verify")
    print("verification: ok", flush=True)
    return proof


def cli(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ziren_tpu_torch.examples.precompiles")
    ap.add_argument("which", nargs="?", default="keccak", choices=sorted(PROGRAMS))
    ap.add_argument("--core", action="store_true", help="the core config, not dev")
    ap.add_argument("--device", default=None,
                    help="where the prover runs: the GPU when left out, cpu, or host")
    return main(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    cli()
