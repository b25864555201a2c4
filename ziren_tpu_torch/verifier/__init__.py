"""Standalone proof verifiers — the TPU-framework analogue of the
reference's portable `no_std` verifier crate (reference:
crates/verifier/src/lib.rs). No dependency on the prover stack: pure-python
BN254 pairing (bn254_pairing.py) + gnark byte formats (groth16.py).

    from ziren_tpu_torch.verifier import Groth16Verifier
    Groth16Verifier.verify(proof_bytes, public_values, vkey_hash, vk_bytes)

Validated against the reference's own committed artifacts
(crates/prover/scripts/artifacts/example_proof.json + the embedded
bn254-vk/groth16_vk.bin) in tests/test_groth16_verifier.py.
"""

from .artifacts import pack_vk, unpack_vk, verify_core_artifact
from .groth16 import Groth16Error, Groth16Verifier, hash_public_inputs
from .stark import (
    verify_compressed,
    verify_machine_proof,
    verify_shard_proof,
)

__all__ = [
    "Groth16Verifier", "Groth16Error", "hash_public_inputs",
    "verify_shard_proof", "verify_machine_proof", "verify_compressed",
    "pack_vk", "unpack_vk", "verify_core_artifact",
]
