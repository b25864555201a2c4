"""Proof containers (reference: crates/stark/src/types.rs ShardProof et al.)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .pcs import FriProof


@dataclass
class AirOpenedValues:
    local: list  # list of (4,) ext values
    next: list


@dataclass
class ChipOpenedValues:
    preprocessed: AirOpenedValues
    main: AirOpenedValues
    permutation: AirOpenedValues  # flattened base columns (perm_width * 4)
    quotient: list  # [chunk][4 ext values]
    local_cumulative_sum: np.ndarray  # (4,)
    global_cumulative_sum: np.ndarray  # (14,) septic point (x, y)
    log_degree: int


@dataclass
class ShardCommitment:
    main: np.ndarray
    permutation: np.ndarray
    quotient: np.ndarray


@dataclass
class ShardProof:
    commitment: ShardCommitment
    opened_values: list  # ChipOpenedValues, in chip_ordering order
    opening_proof: FriProof
    chip_names: list  # ordered (height desc)
    public_values: list

    @property
    def chip_ordering(self) -> dict:
        return {name: i for i, name in enumerate(self.chip_names)}

    def local_cumulative_sum(self):
        from ..core import ext as E

        acc = E.ezero()
        for v in self.opened_values:
            acc = E.eadd(acc, v.local_cumulative_sum)
        return acc


@dataclass
class MachineProof:
    shard_proofs: list
