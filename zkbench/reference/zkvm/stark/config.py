"""STARK configurations (reference: crates/stark/src/kb31_poseidon2.rs).

`core_config()` mirrors the reference's production parameters (log_blowup=1,
84 queries, 16 PoW bits -> ~100 bits with the KoalaBear ext4 field);
`dev_config()` mirrors its ZKM_DEV_MODE (reduced queries) for fast tests.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..core.challenger import DuplexChallenger
from .pcs import FriConfig, TwoAdicFriPcs


@dataclass
class StarkConfig:
    fri: FriConfig

    def __post_init__(self):
        self.pcs = TwoAdicFriPcs(self.fri)

    def challenger(self) -> DuplexChallenger:
        return DuplexChallenger()


def core_config() -> StarkConfig:
    queries = int(os.environ.get("FRI_QUERIES", "84"))
    return StarkConfig(FriConfig(log_blowup=1, num_queries=queries, proof_of_work_bits=16))


def dev_config() -> StarkConfig:
    return StarkConfig(FriConfig(log_blowup=1, num_queries=8, proof_of_work_bits=4))


def compressed_config() -> StarkConfig:
    """The shrink stage's config (reference kb31_poseidon2.rs:217
    compressed_fri_config): higher blowup, fewer queries — same ~100-bit
    target but a SMALLER proof, so the wrap circuit that verifies it (and
    ultimately the Groth16 wrap R1CS) shrinks."""
    queries = int(os.environ.get("FRI_QUERIES", "42"))
    return StarkConfig(FriConfig(log_blowup=2, num_queries=queries, proof_of_work_bits=16))


def compressed_dev_config() -> StarkConfig:
    """Dev-scale shrink config: same blowup/query RATIO as compressed()
    relative to core (half the queries, double the blowup)."""
    return StarkConfig(FriConfig(log_blowup=2, num_queries=4, proof_of_work_bits=4))


# ---------------------------------------------------------------------------
# Outer (wrap) config: KoalaBear values, BN254 commitments & transcript
# (reference: crates/recursion/core/src/stark/config.rs
# KoalaBearPoseidon2Outer — log_blowup=4, 21 queries, 16 PoW bits)
# ---------------------------------------------------------------------------


class Bn254Mmcs:
    """Commitment layer for the outer config: Poseidon2-BN254 Merkle
    (core/outer_merkle.py), single-Fr roots observed as split_32 digits."""

    @staticmethod
    def commit(mats):
        from ..core import outer_merkle

        return outer_merkle.commit(mats)

    @staticmethod
    def open_at(tree, index):
        from ..core import outer_merkle

        return outer_merkle.open_at(tree, index)

    @staticmethod
    def verify_openings_batch(root, dims, idxs, rows_l, paths_l):
        from ..core import outer_merkle

        return outer_merkle.verify_openings_batch(
            root, dims, idxs, rows_l, paths_l
        )

    @staticmethod
    def num_leaves(tree) -> int:
        return len(tree.levels[0])

    @staticmethod
    def observe_root(ch, root) -> None:
        ch.observe_fr(int(root))


@dataclass
class OuterStarkConfig(StarkConfig):
    commit_kind: str = "bn254"
    device_capable: bool = False

    def __post_init__(self):
        self.pcs = TwoAdicFriPcs(self.fri, mmcs=Bn254Mmcs)

    def challenger(self):
        from ..core.bn254 import OuterChallenger

        return OuterChallenger()


def outer_config() -> StarkConfig:
    queries = int(os.environ.get("FRI_QUERIES", "21"))
    return OuterStarkConfig(
        FriConfig(log_blowup=4, num_queries=queries, proof_of_work_bits=16)
    )


def outer_dev_config() -> StarkConfig:
    """Reduced outer parameters for tests (reference ZKM_DEV_MODE: 1 query).
    log_blowup=1 keeps dev-scale wrap LDEs 8x smaller than the production
    outer config's blowup 4; the commitment/transcript layer (the thing the
    outer config exists for) is identical."""
    return OuterStarkConfig(
        FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=2)
    )
