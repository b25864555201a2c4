"""Reference-layout proof serialization (bincode).

Encodes a ShardProof in the byte layout bincode produces for the
reference's `ShardProof<KoalaBearPoseidon2>` (crates/stark/src/types.rs:77
with p3 serde conventions):

  * bincode fixint little-endian: Vec = u64 length + elements, String =
    u64 length + utf8, usize = u64, HashMap = u64 length + entries;
  * KoalaBear serializes as its MONTGOMERY u32 (p3 MontyField31's derived
    serde on the internal representation), extension elements as 4 of
    them, Poseidon2 digests as fixed [F; 8] (no length prefix);
  * FriProof { commit_phase_commits, query_proofs, final_poly, pow_witness }
    with QueryProof { input_proof: Vec<BatchOpening { opened_values:
    Vec<Vec<F>>, opening_proof: Vec<[F; 8]> }>, commit_phase_openings:
    Vec<CommitPhaseProofStep { sibling_value: EF, opening_proof }> } —
    the commit-phase SIBLING (not the pair) is stored, so export replays
    the Fiat-Shamir transcript to learn each query's fold parity.

No Rust toolchain exists in this environment, but the reference SHIPS
bincode-produced binaries that anchor the layout in-env: part_stark_vk.bin
(PartStarkVerifyingKey: Fr bytes + KoalaBear mont u32) and dummy_vk_map.bin
(BTreeMap<[KoalaBear; 8], usize>) decode AND re-encode byte-exactly through
the primitives below (tests/test_interop.py), and the reference's example
gnark Groth16 proof verifies through ziren_tpu.verifier. The ShardProof
composite layout itself (no reference proof bytes are shipped) remains
validated by round-trip only.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from ..core import field as F
from .pcs import FriProof, QueryProof
from .proof import (
    AirOpenedValues,
    ChipOpenedValues,
    ShardCommitment,
    ShardProof,
)

_R = (1 << 32) % F.P_INT
_R_INV = pow(_R, F.P_INT - 2, F.P_INT)


def _monty(v: int) -> int:
    return (int(v) << 32) % F.P_INT


def _unmonty(v: int) -> int:
    return (int(v) * _R_INV) % F.P_INT


class _W:
    def __init__(self):
        self.buf = io.BytesIO()

    def u64(self, v):
        self.buf.write(struct.pack("<Q", int(v)))

    def felt(self, v):
        self.buf.write(struct.pack("<I", _monty(v)))

    def felts(self, arr, prefix=True):
        a = np.asarray(arr, dtype=np.uint32).reshape(-1)
        if prefix:
            self.u64(a.size)
        for v in a:
            self.felt(int(v))

    def ext(self, e):
        self.felts(np.asarray(e, np.uint32).reshape(4), prefix=False)

    def digest(self, d):
        self.felts(np.asarray(d, np.uint32).reshape(8), prefix=False)

    def string(self, s: str):
        b = s.encode()
        self.u64(len(b))
        self.buf.write(b)


class _R_:
    def __init__(self, data: bytes):
        self.buf = io.BytesIO(data)

    def u64(self):
        return struct.unpack("<Q", self.buf.read(8))[0]

    def felt(self):
        return _unmonty(struct.unpack("<I", self.buf.read(4))[0])

    def felts(self, n=None):
        if n is None:
            n = self.u64()
        return np.array([self.felt() for _ in range(n)], dtype=np.uint32)

    def ext(self):
        return self.felts(4)

    def digest(self):
        return self.felts(8)

    def string(self):
        n = self.u64()
        return self.buf.read(n).decode()


# ---------------------------------------------------------------------------
# Reference-produced binary artifacts (the in-env bincode oracles)
# ---------------------------------------------------------------------------


def decode_part_stark_vk(data: bytes):
    """crates/verifier/bn254-vk/part_stark_vk.bin — bincode of
    PartStarkVerifyingKey<KoalaBearPoseidon2Outer> { commit: Bn254 Fr,
    pc_start: KoalaBear } (reference stark/src/machine.rs:109-114,
    prover/src/verify.rs:499-506). The Fr serializes as a 32-byte
    little-endian Vec<u8>; pc_start as its Montgomery u32."""
    r = _R_(data)
    n = r.u64()
    if n != 32:
        raise ValueError(f"part_stark_vk: expected 32-byte commit, got {n}")
    commit = int.from_bytes(r.buf.read(32), "little")
    bn254_r = 21888242871839275222246405745257275088548364400416034343698204186575808495617
    if commit >= bn254_r:
        raise ValueError("part_stark_vk: commit not a BN254 Fr element")
    pc_start = r.felt()
    if r.buf.read(1):
        raise ValueError("part_stark_vk: trailing bytes")
    return commit, int(pc_start)


def encode_part_stark_vk(commit: int, pc_start: int) -> bytes:
    w = _W()
    w.u64(32)
    w.buf.write(int(commit).to_bytes(32, "little"))
    w.felt(pc_start)
    return w.buf.getvalue()


def decode_vk_map(data: bytes):
    """crates/prover/dummy_vk_map.bin / vk_map.bin — bincode of
    BTreeMap<[KoalaBear; 8], usize> (reference prover/src/shapes.rs:329-337,
    lib.rs:226-240): u64 count, then sorted (8 x mont u32 digest, u64 index)
    entries. Returns [(canonical (8,) uint32 digest, index)] in file order."""
    r = _R_(data)
    n = r.u64()
    entries = []
    for _ in range(n):
        digest = r.digest()  # mont -> canonical
        idx = r.u64()
        entries.append((digest, idx))
    if r.buf.read(1):
        raise ValueError("vk_map: trailing bytes")
    return entries


def encode_vk_map(entries) -> bytes:
    w = _W()
    w.u64(len(entries))
    for digest, idx in entries:
        w.felts(np.asarray(digest, np.uint32).reshape(8), prefix=False)
        w.u64(idx)
    return w.buf.getvalue()


def _query_indices(machine, vk, proof: ShardProof):
    """Replay the shard transcript to the FRI query indices (the exported
    commit-phase steps store the sibling, selected by index parity)."""
    fri = machine.config.fri
    ch = machine.config.challenger()
    vk.observe_into(ch)
    ch.observe_slice(np.asarray(proof.public_values, dtype=np.uint32))
    mmcs = machine.config.pcs.mmcs
    mmcs.observe_root(ch, proof.commitment.main)
    ch.sample_ext()
    ch.sample_ext()
    mmcs.observe_root(ch, proof.commitment.permutation)
    for vals in proof.opened_values:
        ch.observe_slice(np.asarray(vals.local_cumulative_sum, np.uint32))
        ch.observe_slice(np.asarray(vals.global_cumulative_sum, np.uint32))
    ch.sample_ext()  # alpha (quotient)
    mmcs.observe_root(ch, proof.commitment.quotient)
    ch.sample_ext()  # zeta
    ch.sample_ext()  # alpha (FRI reduced openings)
    fp = proof.opening_proof
    for c in fp.commit_phase_commits:
        mmcs.observe_root(ch, c)
        ch.sample_ext()  # beta
    ch.observe_slice(np.asarray(fp.final_poly, np.uint32))
    assert ch.check_witness(fri.proof_of_work_bits, fp.pow_witness)
    log_max = len(fp.commit_phase_commits) + fri.log_blowup
    return [ch.sample_bits(log_max) for _ in range(fri.num_queries)]


def serialize_shard_proof_reference(machine, vk, proof: ShardProof) -> bytes:
    """ShardProof -> reference bincode layout (see module docstring)."""
    w = _W()
    # ShardCommitment<Com>: 3 fixed digests
    w.digest(proof.commitment.main)
    w.digest(proof.commitment.permutation)
    w.digest(proof.commitment.quotient)
    # ShardOpenedValues { chips: Vec<ChipOpenedValues> }
    w.u64(len(proof.opened_values))
    for vals in proof.opened_values:
        for air in (vals.preprocessed, vals.main, vals.permutation):
            w.u64(len(air.local))
            for e in air.local:
                w.ext(e)
            w.u64(len(air.next))
            for e in air.next:
                w.ext(e)
        w.u64(len(vals.quotient))
        for chunk in vals.quotient:
            # one chunk = the 4 base quotient columns' EF openings
            rows = np.asarray(chunk, np.uint32).reshape(-1, 4)
            w.u64(rows.shape[0])
            for e in rows:
                w.ext(e)
        # SepticDigest<F>: SepticCurve { x: [F;7], y: [F;7] }
        g = np.asarray(vals.global_cumulative_sum, np.uint32)
        w.felts(g[:7], prefix=False)
        w.felts(g[7:14], prefix=False)
        w.ext(vals.local_cumulative_sum)
        w.u64(vals.log_degree)
    # OpeningProof = FriProof
    fp = proof.opening_proof
    idxs = _query_indices(machine, vk, proof)
    w.u64(len(fp.commit_phase_commits))
    for c in fp.commit_phase_commits:
        w.digest(c)
    w.u64(len(fp.query_proofs))
    for idx, qp in zip(idxs, fp.query_proofs):
        # input_proof: Vec<BatchOpening>
        w.u64(len(qp.input_openings))
        for rows, path in qp.input_openings:
            w.u64(len(rows))
            for row in rows:
                w.felts(row)
            w.u64(len(path))
            for digest in path:
                w.digest(digest)
        # commit_phase_openings: sibling value + path
        w.u64(len(qp.commit_phase_openings))
        i = idx
        for pair, path in qp.commit_phase_openings:
            sibling = np.asarray(pair, np.uint32).reshape(2, 4)[(i & 1) ^ 1]
            w.ext(sibling)
            w.u64(len(path))
            for digest in path:
                w.digest(digest)
            i >>= 1
    # final_poly (constant: one ext element) + pow witness
    w.ext(fp.final_poly)
    w.felt(fp.pow_witness)
    # chip_ordering: HashMap<String, usize> in chip order
    w.u64(len(proof.chip_names))
    for i, name in enumerate(proof.chip_names):
        w.string(name)
        w.u64(i)
    # public values
    w.u64(len(proof.public_values))
    for v in proof.public_values:
        w.felt(v)
    return w.buf.getvalue()


def deserialize_shard_proof_reference(machine, data: bytes) -> ShardProof:
    """Decode the reference layout back into our ShardProof. The
    commit-phase PAIR is reconstructed lazily: the sibling goes into both
    slots and verify_shard recomputes the folded entry from the chain, so
    decoded proofs re-serialize identically but must be verified through
    the reference-style sibling reconstruction (tests do byte round-trip)."""
    r = _R_(data)
    commitment = ShardCommitment(r.digest(), r.digest(), r.digest())
    n_chips = r.u64()
    opened = []
    for _ in range(n_chips):
        airs = []
        for _ in range(3):
            local = [r.ext() for _ in range(r.u64())]
            nxt = [r.ext() for _ in range(r.u64())]
            airs.append(AirOpenedValues(local, nxt))
        quotient = []
        for _ in range(r.u64()):
            n = r.u64()
            quotient.append(np.stack([r.ext() for _ in range(n)]))
        gx = r.felts(7)
        gy = r.felts(7)
        lcs = r.ext()
        log_degree = r.u64()
        opened.append(
            ChipOpenedValues(
                preprocessed=airs[0], main=airs[1], permutation=airs[2],
                quotient=quotient,
                local_cumulative_sum=lcs,
                global_cumulative_sum=np.concatenate([gx, gy]),
                log_degree=log_degree,
            )
        )
    n_cp = r.u64()
    cp_commits = [r.digest() for _ in range(n_cp)]
    n_q = r.u64()
    query_proofs = []
    for _ in range(n_q):
        input_openings = []
        for _ in range(r.u64()):
            rows = [r.felts() for _ in range(r.u64())]
            path = [r.digest() for _ in range(r.u64())]
            input_openings.append((rows, path))
        cp_openings = []
        for _ in range(r.u64()):
            sibling = r.ext()
            path = [r.digest() for _ in range(r.u64())]
            pair = np.stack([sibling, sibling])
            cp_openings.append((pair, path))
        query_proofs.append(QueryProof(input_openings, cp_openings))
    final_poly = r.ext()
    pow_witness = r.felt()
    n_names = r.u64()
    names = [None] * n_names
    for _ in range(n_names):
        s = r.string()
        names[r.u64()] = s
    pv = [int(v) for v in r.felts()]
    fri_proof = FriProof(cp_commits, query_proofs, final_poly, pow_witness)
    return ShardProof(
        commitment=commitment, opened_values=opened,
        opening_proof=fri_proof, chip_names=names, public_values=pv,
    )
