"""profile_device (ziren_tpu_torch/tools/profile_device.py, the port of
tools/profile_device.py) on the CPU at the smallest fibonacci that makes
two shards: every leg printed, the serial legs' proof verified and
byte-equal to machine.prove's. The JAX script drives the TPU prover's
dispatch directly, so it is not run beside it."""

import os

import torch

from test_torch_drivers import CPU
from ziren_tpu_torch.machine.mips import verify_mips_proof
from ziren_tpu_torch.stark.serialize import serialize_machine_proof
from ziren_tpu_torch.tools import profile_device

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def test_profile_device_two_shards(capsys):
    out = profile_device.cli(["200", "1024", *CPU])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "backend=torch devices=cpu"
    assert lines[1].startswith("exec=") and lines[1].endswith(" shards=2 cycles=1210")
    assert [ln.split("=")[0] for ln in lines[2].split()] == ["gen", "dispatch", "fetch",
                                                              "assemble"]
    assert lines[3].startswith("serial total=") and lines[4] == "verified"
    assert lines[5].startswith("machine.prove=") and len(lines) == 6
    assert list(out["legs"]) == ["exec", "est", "warmup", "gen", "dispatch", "fetch",
                                 "assemble", "serial_total", "machine.prove"]
    serial, pipelined = out["proofs"]
    assert len(serial.shard_proofs) == 2
    assert serialize_machine_proof(serial) == serialize_machine_proof(pipelined)
    assert verify_mips_proof(out["machine"], out["vk"], pipelined,
                             pc_start=out["program"].pc_start)
