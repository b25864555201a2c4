"""profile_prove (ziren_tpu_torch/tools/profile_prove.py) against the JAX
repo's tools/profile_prove.py on the CPU, as tests/test_torch_drivers.py
holds the other drivers: the cycles both print, the profile's table, and
the proofs' bytes."""

import os

import torch

from test_torch_drivers import CPU, caught, run_script
from ziren_tpu.stark.machine import StarkMachine as JStarkMachine
from ziren_tpu.stark.serialize import serialize_machine_proof as jserialize
from ziren_tpu_torch.stark.serialize import serialize_machine_proof
from ziren_tpu_torch.tools import profile_prove

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def test_profile_prove(capsys):
    with caught(JStarkMachine, "prove") as jproofs:
        jout = run_script("tools/profile_prove.py", [], capsys)
    proof = profile_prove.cli(CPU)
    tout = capsys.readouterr().out

    def cycles(out):
        return out.splitlines()[0].split()[0]

    assert cycles(tout) == cycles(jout) == "cycles=3010"
    assert "function calls" in tout and "Ordered by: cumulative time" in tout
    assert serialize_machine_proof(proof) == jserialize(jproofs[0])
