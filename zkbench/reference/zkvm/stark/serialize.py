"""Proof serialization: compact little-endian binary encoding + sizes
(reference: the bincode-serialized ShardProof in crates/stark/src/types.rs;
the layout here is ours — bit-exact reference interop is a later milestone).

Format (all u32 LE unless noted):
  MachineProof: u32 n_shards, then each ShardProof
  ShardProof: 3 x digest(8), chip table, opened values, FRI proof, pv
"""

from __future__ import annotations

import io
import struct

import numpy as np

from .pcs import FriProof, QueryProof
from .proof import (
    AirOpenedValues,
    ChipOpenedValues,
    MachineProof,
    ShardCommitment,
    ShardProof,
)


def _w_u32s(buf, arr):
    a = np.asarray(arr, dtype=np.uint32)
    buf.write(struct.pack("<I", a.size))
    buf.write(a.tobytes())


def _r_u32s(buf):
    (n,) = struct.unpack("<I", buf.read(4))
    return np.frombuffer(buf.read(4 * n), dtype=np.uint32).copy()


def _w_vals(buf, vals):
    _w_u32s(buf, np.asarray(list(vals), dtype=np.uint32).reshape(-1))


def _w_str(buf, s):
    b = s.encode()
    buf.write(struct.pack("<I", len(b)))
    buf.write(b)


def _r_str(buf):
    (n,) = struct.unpack("<I", buf.read(4))
    return buf.read(n).decode()


def serialize_shard_proof(sp: ShardProof) -> bytes:
    buf = io.BytesIO()
    for c in (sp.commitment.main, sp.commitment.permutation, sp.commitment.quotient):
        buf.write(np.asarray(c, np.uint32).tobytes())
    buf.write(struct.pack("<I", len(sp.chip_names)))
    for name, ov in zip(sp.chip_names, sp.opened_values):
        _w_str(buf, name)
        buf.write(struct.pack("<I", ov.log_degree))
        for av in (ov.preprocessed, ov.main, ov.permutation):
            _w_vals(buf, np.concatenate([np.asarray(v, np.uint32) for v in av.local])
                    if av.local else np.zeros(0, np.uint32))
            _w_vals(buf, np.concatenate([np.asarray(v, np.uint32) for v in av.next])
                    if av.next else np.zeros(0, np.uint32))
        buf.write(struct.pack("<I", len(ov.quotient)))
        for chunk in ov.quotient:
            _w_vals(buf, np.concatenate([np.asarray(v, np.uint32) for v in chunk]))
        buf.write(np.asarray(ov.local_cumulative_sum, np.uint32).tobytes())
        buf.write(np.asarray(ov.global_cumulative_sum, np.uint32).tobytes())
    # FRI proof
    fp = sp.opening_proof
    buf.write(struct.pack("<I", len(fp.commit_phase_commits)))
    for c in fp.commit_phase_commits:
        buf.write(np.asarray(c, np.uint32).tobytes())
    buf.write(np.asarray(fp.final_poly, np.uint32).tobytes())
    buf.write(struct.pack("<Q", fp.pow_witness))
    buf.write(struct.pack("<I", len(fp.query_proofs)))
    for qp in fp.query_proofs:
        buf.write(struct.pack("<I", len(qp.input_openings)))
        for rows, path in qp.input_openings:
            buf.write(struct.pack("<I", len(rows)))
            for row in rows:
                _w_u32s(buf, row)
            buf.write(struct.pack("<I", len(path)))
            for d in path:
                buf.write(np.asarray(d, np.uint32).tobytes())
        buf.write(struct.pack("<I", len(qp.commit_phase_openings)))
        for pair, path in qp.commit_phase_openings:
            buf.write(np.asarray(pair, np.uint32).tobytes())
            buf.write(struct.pack("<I", len(path)))
            for d in path:
                buf.write(np.asarray(d, np.uint32).tobytes())
    _w_vals(buf, sp.public_values)
    return buf.getvalue()


def deserialize_shard_proof(data: bytes) -> ShardProof:
    buf = io.BytesIO(data)
    rd_digest = lambda: np.frombuffer(buf.read(32), dtype=np.uint32).copy()
    commitment = ShardCommitment(rd_digest(), rd_digest(), rd_digest())
    (n_chips,) = struct.unpack("<I", buf.read(4))
    names, opened = [], []
    for _ in range(n_chips):
        name = _r_str(buf)
        (log_degree,) = struct.unpack("<I", buf.read(4))
        avs = []
        for _ in range(3):
            local = _r_u32s(buf).reshape(-1, 4)
            nxt = _r_u32s(buf).reshape(-1, 4)
            avs.append(AirOpenedValues(list(local), list(nxt)))
        (n_chunks,) = struct.unpack("<I", buf.read(4))
        quotient = []
        for _ in range(n_chunks):
            quotient.append(list(_r_u32s(buf).reshape(-1, 4)))
        lsum = np.frombuffer(buf.read(16), dtype=np.uint32).copy()
        gsum = np.frombuffer(buf.read(56), dtype=np.uint32).copy()
        names.append(name)
        opened.append(
            ChipOpenedValues(avs[0], avs[1], avs[2], quotient, lsum, gsum, log_degree)
        )
    (n_cp,) = struct.unpack("<I", buf.read(4))
    cp_commits = [np.frombuffer(buf.read(32), dtype=np.uint32).copy() for _ in range(n_cp)]
    final_poly = np.frombuffer(buf.read(16), dtype=np.uint32).copy()
    (pow_witness,) = struct.unpack("<Q", buf.read(8))
    (n_q,) = struct.unpack("<I", buf.read(4))
    queries = []
    for _ in range(n_q):
        (n_rounds,) = struct.unpack("<I", buf.read(4))
        input_openings = []
        for _ in range(n_rounds):
            (n_rows,) = struct.unpack("<I", buf.read(4))
            rows = [_r_u32s(buf) for _ in range(n_rows)]
            (n_path,) = struct.unpack("<I", buf.read(4))
            path = [np.frombuffer(buf.read(32), dtype=np.uint32).copy() for _ in range(n_path)]
            input_openings.append((rows, path))
        (n_cpo,) = struct.unpack("<I", buf.read(4))
        cp_openings = []
        for _ in range(n_cpo):
            pair = np.frombuffer(buf.read(32), dtype=np.uint32).copy().reshape(2, 4)
            (n_path,) = struct.unpack("<I", buf.read(4))
            path = [np.frombuffer(buf.read(32), dtype=np.uint32).copy() for _ in range(n_path)]
            cp_openings.append((pair, path))
        queries.append(QueryProof(input_openings, cp_openings))
    pv = [int(x) for x in _r_u32s(buf)]
    fri = FriProof(cp_commits, queries, final_poly, pow_witness)
    return ShardProof(commitment, opened, fri, names, pv)


def serialize_machine_proof(mp: MachineProof) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack("<I", len(mp.shard_proofs)))
    for sp in mp.shard_proofs:
        b = serialize_shard_proof(sp)
        buf.write(struct.pack("<I", len(b)))
        buf.write(b)
    return buf.getvalue()


def deserialize_machine_proof(data: bytes) -> MachineProof:
    buf = io.BytesIO(data)
    (n,) = struct.unpack("<I", buf.read(4))
    shards = []
    for _ in range(n):
        (sz,) = struct.unpack("<I", buf.read(4))
        shards.append(deserialize_shard_proof(buf.read(sz)))
    return MachineProof(shards)
