"""Portable STARK verifiers (reference: crates/verifier/src/stark/verify.rs
— the no_std compressed-proof verifier with embedded vks).

Verification needs only numpy + the host-side core modules (field, ext,
poseidon2, merkle, challenger): no accelerator, no jax session state. This
module packages the three verification entry points a consumer embeds:

  * `verify_shard_proof`   — one shard proof against a machine + vk
  * `verify_machine_proof` — all shards + the cross-shard septic balance
  * `verify_compressed`    — ONE recursion proof whose RecursionPublicValues
    pin the MIPS vk, program entry and is_complete=1 (which in-circuit
    implies shard 1..halt coverage, exit code 0, a ZERO septic digest and
    a fully-reconstructed deferred-proof chain); returns the 32
    committed_value_digest bytes.

The machine/vk objects play the role of the reference's embedded vk
binaries; serialize them with stark/serialize.py (ours) or export proofs
in the reference bincode layout via stark/interop.py.
"""

from __future__ import annotations


def verify_shard_proof(machine, vk, shard_proof) -> bool:
    from ..stark.verifier import verify_shard

    ch = machine.config.challenger()
    vk.observe_into(ch)
    verify_shard(machine, vk, shard_proof, ch)
    return True


def verify_machine_proof(machine, vk, machine_proof) -> bool:
    return machine.verify(vk, machine_proof)


def verify_compressed(mips_machine, mips_vk, rec_machine, rec_vk, final_sp,
                      pc_start=None, vk_root=None, registry=None) -> bytes:
    from ..recursion.mips_pipeline import (
        verify_compressed as _verify,
    )

    return _verify(mips_machine, mips_vk, rec_machine, rec_vk, final_sp,
                   pc_start=pc_start, vk_root=vk_root, registry=registry)
