"""SysLinux and the boolean-circuit garble chip through the port's shard
prover, on the CPU. The syscalls group (ziren_tpu_torch.tools.
precompile_programs: the Linux calls of the SysLinux chip's oracle test and
a three-gate garble) is proved at the dev config by the JAX package's host
prover and by the port's torch prover: the same bytes, each verifier taking
the other's (tests/test_torch_precompiles.py)."""

import pytest

from test_torch_precompiles import check_group, prove_group

from ziren_tpu.executor import Executor as JExecutor
from ziren_tpu_torch.executor import Executor as TExecutor


@pytest.fixture(scope="module")
def syscalls():
    return prove_group("syscalls")


def test_syscalls_group_matches_jax(syscalls):
    check_group(syscalls)


def test_the_garble_result_is_zero(syscalls):
    """The third gate's ciphertext does not match: the garble call gives 0,
    on the port's executor as on the JAX package's."""
    for executor, program in ((TExecutor, syscalls.program),
                              (JExecutor, syscalls.jax_program)):
        ex = executor(program)
        ex.run()
        assert ex.peek_register(20) == 0
