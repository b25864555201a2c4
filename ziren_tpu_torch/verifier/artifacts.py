"""Portable verifier artifacts: a self-contained binary carrying everything
a verifier needs beyond the code — the MIPS verifying key (preprocessed
commitment + chip table), the program entry, the FRI config, and optionally
the allowed-vk registry root (reference: crates/verifier/src/lib.rs:9-24
embedded vk binaries + sdk/src/install.rs artifact installation).

With an artifact file and serialized proof bytes, `verify_core_artifact`
runs the full core verification (shard proofs + public-value chaining +
septic balance) without touching the prover stack's setup path — the
"ship two files to a verifier" parity point.

Format (little-endian):
    magic "ZIRNVK1\\0" | u32 flags | fri(log_blowup, queries, pow bits)
    | u32 pc_start | commit felts | chip table | extra observations
    | [registry root felts]         (flags bit 0)
"""

from __future__ import annotations

import io
import struct

import numpy as np

MAGIC = b"ZIRNVK1\x00"
_FLAG_ROOT = 1


def _w_u32s(buf, arr):
    a = np.asarray(arr, dtype=np.uint32).reshape(-1)
    buf.write(struct.pack("<I", a.size))
    buf.write(a.tobytes())


def _r_u32s(buf):
    (n,) = struct.unpack("<I", buf.read(4))
    return np.frombuffer(buf.read(4 * n), dtype=np.uint32).copy()


def _w_str(buf, s):
    b = s.encode()
    buf.write(struct.pack("<I", len(b)))
    buf.write(b)


def _r_str(buf):
    (n,) = struct.unpack("<I", buf.read(4))
    return buf.read(n).decode()


def pack_vk(machine, vk, pc_start: int = 0, registry_root=None) -> bytes:
    """Serialize a core verifying key (+ optional allowed-vk registry root)
    into the portable artifact format."""
    fri = machine.config.fri
    buf = io.BytesIO()
    buf.write(MAGIC)
    flags = _FLAG_ROOT if registry_root is not None else 0
    buf.write(struct.pack("<IIIII", flags, fri.log_blowup, fri.num_queries,
                          fri.proof_of_work_bits, int(pc_start)))
    _w_u32s(buf, vk.commit)
    buf.write(struct.pack("<I", len(vk.chip_information)))
    for name, dom, dims, local_only in vk.chip_information:
        _w_str(buf, name)
        buf.write(struct.pack("<IIIII", dom.log_n, dom.shift,
                              int(dims[0]), int(dims[1]), int(local_only)))
    _w_u32s(buf, [int(x) for x in vk.extra_observations])
    if registry_root is not None:
        _w_u32s(buf, registry_root)
    return buf.getvalue()


def unpack_vk(data: bytes):
    """-> (machine, vk, pc_start, registry_root | None). The MIPS machine
    is rebuilt from code at the artifact's FRI config — the artifact pins
    everything run-specific."""
    from ..machine.mips import mips_machine
    from ..stark.config import FriConfig, StarkConfig
    from ..stark.domain import Domain
    from ..stark.machine import VerifyingKey

    buf = io.BytesIO(data)
    assert buf.read(8) == MAGIC, "bad artifact magic"
    flags, lb, q, pow_bits, pc_start = struct.unpack("<IIIII", buf.read(20))
    commit = _r_u32s(buf)
    (n_chips,) = struct.unpack("<I", buf.read(4))
    chip_information = []
    for _ in range(n_chips):
        name = _r_str(buf)
        log_n, shift, h, w, lo = struct.unpack("<IIIII", buf.read(20))
        chip_information.append(
            (name, Domain(log_n, shift), (h, w), bool(lo)))
    extras = [int(v) for v in _r_u32s(buf)]
    root = _r_u32s(buf) if flags & _FLAG_ROOT else None
    vk = VerifyingKey(commit=commit, chip_information=chip_information,
                      extra_observations=extras)
    machine = mips_machine(
        StarkConfig(FriConfig(log_blowup=lb, num_queries=q,
                              proof_of_work_bits=pow_bits)))
    return machine, vk, pc_start, root


def verify_core_artifact(artifact: bytes, proof_bytes: bytes) -> bool:
    """Full core verification from two byte strings: the artifact and a
    serialized MachineProof (stark/serialize.py). Runs verify_mips_proof
    (shard proofs + pv chaining rules + septic global balance)."""
    from ..machine.mips import verify_mips_proof
    from ..stark.serialize import deserialize_machine_proof

    machine, vk, pc_start, _root = unpack_vk(artifact)
    proof = deserialize_machine_proof(proof_bytes)
    return verify_mips_proof(machine, vk, proof, pc_start=pc_start or None)
