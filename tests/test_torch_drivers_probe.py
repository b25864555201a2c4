"""device_probe (ziren_tpu_torch/tools/device_probe.py, the port of
tools/tpu_probe.py) on the CPU at the smallest fibonacci that makes two
shards: every stage logged in order, the warm proof verified, and the
first shard's proof from the probe's own dispatch byte-equal to the warm
prove's first shard. The JAX script drives the TPU prover's stages
directly, so it is not run beside it."""

import os

import torch

from test_torch_drivers import CPU
from ziren_tpu_torch.machine.mips import verify_mips_proof
from ziren_tpu_torch.stark.serialize import serialize_shard_proof
from ziren_tpu_torch.tools import device_probe

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

STAGES = ["devices=cpu", "setup done", "exec done: 2 shards, 1210 cycles", "targets: ",
          "trace gen shard0 done: ", "upload done in ", "preprocessed commit done in ",
          "main commit done in ", "dispatch done in ", "fetch done in ", "assembled",
          "WARM: exec ", "verified", "warm shard legs: gen "]


def test_device_probe_two_shards(capsys):
    out = device_probe.cli(["200", "1024", *CPU])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(STAGES)
    for line, stage in zip(lines, STAGES):
        assert line[:2] == "[ " or line[0] == "[", line
        assert line.split("] ", 1)[1].startswith(stage), (line, stage)
    assert list(out["stages"]) == ["upload", "preprocessed_commit", "main_commit", "dispatch",
                                   "fetch", "assemble", "warm_prove", "warm_exec", "warm_gen",
                                   "warm_dispatch", "warm_fetch", "warm_assemble"]
    proof = out["proof"]
    assert out["cycles"] == 1210 and len(proof.shard_proofs) == 2
    assert verify_mips_proof(out["machine"], out["vk"], proof, pc_start=out["program"].pc_start)
    assert serialize_shard_proof(out["first_shard"]) == serialize_shard_proof(
        proof.shard_proofs[0])
