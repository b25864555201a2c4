"""The Weierstrass curve chips through the port's shard prover, on the CPU:
add and double on secp256k1, secp256r1, bn254 and bls12-381, and decompress
on secp256k1, secp256r1 and bls12-381, in one grouped program
(ziren_tpu_torch.tools.precompile_programs). The JAX package's host proof
and the port's torch proof at the dev config are the same bytes, and each
package's verifier takes the other's (tests/test_torch_precompiles.py)."""

import pytest

from test_torch_precompiles import check_group, prove_group

import ziren_tpu.executor as jexecutor
import ziren_tpu.executor.asm as jasm


@pytest.fixture(scope="module")
def weierstrass():
    return prove_group("weierstrass")


def test_weierstrass_group_matches_jax(weierstrass):
    check_group(weierstrass)


def test_weierstrass_group_computes_the_points(weierstrass):
    """The last call of the group, bls12-381's decompress, leaves the
    generator's y for sign 0 in r20 (its low word), on both executors."""
    want = jasm.wdecompress_reference("bls12381", 0) & 0xFFFFFFFF
    ex = jexecutor.Executor(weierstrass.jax_program)
    ex.run()
    assert ex.peek_register(20) == want
    assert weierstrass.record.public_values.exit_code == 0
