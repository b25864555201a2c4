"""In-house BN254 Groth16 SNARK layer (reference: the gnark FFI —
crates/recursion/gnark-ffi — replaced by a self-contained implementation:
the environment has no Go toolchain, and the pairing/curve math already
lives in ziren_tpu/verifier/bn254_pairing.py).

`groth16.setup / prove` operate over a sparse R1CS and emit proofs and
verifying keys in gnark's byte layout, so ziren_tpu.verifier's portable
Groth16Verifier (and any gnark-compatible verifier, e.g. the on-chain
contracts) accepts them.
"""

from .groth16 import R1CS, prove, setup

__all__ = ["R1CS", "setup", "prove"]
