"""The port's precompile and network examples (ziren_tpu_torch/examples)
against the JAX repo's (examples/), on the CPU, as tests/test_torch_drivers.py
holds the other drivers: what both print, with timings and the server's
port left out, and the proofs' bytes."""

import os

import torch

import ziren_tpu.machine.mips as jmips
from test_torch_drivers import CPU, caught, run_script
from ziren_tpu.network import NetworkProver as JNetworkProver
from ziren_tpu.stark.serialize import serialize_machine_proof as jserialize
from ziren_tpu_torch.examples import network_prover, precompiles
from ziren_tpu_torch.stark.serialize import serialize_machine_proof

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def test_precompiles_keccak(capsys):
    with caught(jmips, "prove_program") as jproofs:
        jout = run_script("examples/precompiles.py", ["keccak"], capsys)
    proof = precompiles.cli(["keccak", *CPU])
    tout = capsys.readouterr().out
    jlines, tlines = jout.splitlines(), tout.splitlines()
    assert tlines[0].split(" proved")[0] == jlines[0].split(" proved")[0] == "keccak: 122 cycles"
    assert tlines[1] == jlines[1] and "'KeccakSponge'" in tlines[1]
    assert tlines[2:] == jlines[2:] == ["verification: ok"]
    assert serialize_machine_proof(proof) == jserialize(jproofs[0][3])


def test_network_prover(capsys):
    with caught(JNetworkProver, "prove") as jproofs:
        jout = run_script("examples/network_prover.py", [], capsys)
    proof = network_prover.cli(CPU)
    tout = capsys.readouterr().out
    jlines, tlines = jout.splitlines(), tout.splitlines()
    for t, j in ((tlines[0], jlines[0]),):  # the endpoint's port differs
        assert t.startswith("prover service: http://127.0.0.1:") and t.endswith(
            " (HMAC-signed requests)") and j.endswith(" (HMAC-signed requests)")
    assert tlines[1:] == jlines[1:]
    assert tlines[2] == "proved remotely: 1 shard(s), verified locally - ok"
    assert serialize_machine_proof(proof.proof) == jserialize(jproofs[0].proof)
