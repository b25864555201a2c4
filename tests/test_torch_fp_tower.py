"""The Edwards chips and the Fp / Fp2 tower through the port's shard prover,
on the CPU: ED_ADD and ED_DECOMPRESS on ed25519, and the twelve bn254 and
bls12-381 Fp / Fp2 add, sub and mul chips, in one grouped program
(ziren_tpu_torch.tools.precompile_programs). The JAX package's host proof
and the port's torch proof at the dev config are the same bytes, and each
package's verifier takes the other's (tests/test_torch_precompiles.py)."""

import pytest

from test_torch_precompiles import check_group, prove_group

import ziren_tpu.executor as jexecutor
from ziren_tpu_torch.tools import precompile_programs as pp


@pytest.fixture(scope="module")
def edwards_fp():
    return prove_group("edwards_fp")


def test_edwards_fp_group_matches_jax(edwards_fp):
    check_group(edwards_fp)


def test_edwards_fp_group_computes_the_last_product(edwards_fp):
    """The group's last call is bn254's Fp2 mul: r20 holds the low word of
    the real part a0 b0 - a1 b1."""
    lo, x, y, nw = pp.FP_CASES[-1]
    a0, a1 = x & ((1 << 256) - 1), x >> 256
    b0, b1 = y & ((1 << 256) - 1), y >> 256
    ex = jexecutor.Executor(edwards_fp.jax_program)
    ex.run()
    assert lo == 0x2B and ex.peek_register(20) == (a0 * b0 - a1 * b1) % pp.PBN & 0xFFFFFFFF
