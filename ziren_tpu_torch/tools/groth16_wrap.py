"""End-to-end Groth16-of-wrap driver: engine proof -> compress -> shrink ->
wrap (BN254 outer config) -> wrap-verifier R1CS -> Groth16 prove -> verify
(reference: the full prover/src/lib.rs prove_groth16 ladder, with
snark/wrap_circuit.py replacing the gnark stage).

    python -m ziren_tpu_torch.tools.groth16_wrap [--out artifact.pkl] [--mips]
        [--fib-n N] [--device cpu|host|cuda:K]

Without --mips the proof to wrap is the engine machine's (tools/engine_air.py,
two FibonacciAir shards of 16 and 32 rows); with it, a MIPS fibonacci(N)
guest through ProverClient(config="dev").compressed_prove. Everything up to
and including shrink runs on the GPU unless --device names the CPU or the
host numpy prover (without a card and without --device it fails). The wrap
and the SNARK stay on the host: wrap_bn254 proves with the host prover, the
only one the outer BN254 config has, and the Groth16 setup and prove are the
native MSM/NTT. EXPENSIVE: ~3M constraints at dev FRI params; the dev-grade
seed-derived setup and the prove take tens of minutes of host time.
"""

from __future__ import annotations

import argparse
import pickle
import time

from ..device import prover_device
from ..executor.asm import fibonacci_program
from ..recursion.pipeline import compress, shrink, wrap_bn254
from ..sdk import ProverClient
from ..stark.config import dev_config, outer_dev_config
from ..stark.machine import StarkMachine
from ..stark.verifier import VerificationError
from .engine_air import FibonacciAir, Record, fib_pv


def main(out="groth16_wrap_artifact.pkl", mips=False, fib_n=20, device=None):
    device = prover_device(device)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time()-t0:7.1f}s] {msg}", flush=True)

    client = ProverClient(config="dev", device=device)
    if mips:
        pk, vk = client.setup(fibonacci_program(fib_n))
        rm, rvk, final_sp = client.compressed_prove(pk)
        log(f"MIPS core prove + compress (fib {fib_n})")
    else:
        m = StarkMachine(dev_config(), [FibonacciAir()],
                         num_public_values=3)
        pk, vk = m.setup()
        proof = m.prove(pk, [Record(n=16, pv=fib_pv(16)),
                             Record(n=32, pv=fib_pv(32))], device=device)
        log("engine proof")
        rm, rvk, final_sp = compress(m, vk, proof, device=device)
        log("compress")
    sm, svk, sproof, _ = shrink(rm, rvk, final_sp, device=device)
    log("shrink")
    wm, wvk, wproof, _ = wrap_bn254(
        sm, svk, sproof.shard_proofs[0], config=outer_dev_config()
    )
    wsp = wproof.shard_proofs[0]
    log("wrap (BN254 outer)")

    artifact = client.groth16_prove((wm, wvk, wsp))
    log(f"groth16 prove ({len(artifact['proof'])} bytes)")
    if not ProverClient.groth16_verify(artifact):
        raise VerificationError("the Groth16 proof does not verify")
    log("groth16 verify OK")

    with open(out, "wb") as f:
        pickle.dump(artifact, f)
    log(f"artifact -> {out}")
    return artifact


def cli(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ziren_tpu_torch.tools.groth16_wrap")
    ap.add_argument("--out", default="groth16_wrap_artifact.pkl")
    ap.add_argument("--mips", action="store_true",
                    help="run the REAL zkVM pipeline (MIPS guest -> core "
                         "shards -> compress) instead of the engine machine")
    ap.add_argument("--fib-n", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="where the STARK provers run: the GPU when left out, cpu, or host")
    return main(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    cli()
