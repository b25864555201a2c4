"""Allowed-vk Merkle registry (reference: crates/prover/src/shapes.rs:33-90
build_vk_map + lib.rs:228-240 vk_map.bin).

The shape system (stark/shape.py) makes the set of lift programs FINITE:
same-shaped inner proofs share one recursion machine/vk, and grid-rounded
shapes collapse different programs' height profiles onto one cluster. This
module enumerates that vk set and commits it in a Poseidon2 Merkle tree:

  * `VkRegistry` — a Merkle tree over 8-felt recursion-vk commits; `root`
    is the single trust anchor, `membership(commit)` the (index, path)
    opening, `verify_membership` the host check.
  * `traced_membership` — the in-circuit gadget: hinted index bits + path
    digests, Merkle-verified against a root of handles (used by the join
    layers once programs are built symbolically from shapes; the concrete
    tracer binds it to real registries today — see tests).

The reference builds vk_map offline over every enumerated proof shape
(days of compute); here registries are built from the lift vks actually
reachable from a machine's shape clusters.
"""

from __future__ import annotations

import numpy as np

from ..core import merkle
from .verifier import traced_merkle_verify


class VkRegistry:
    def __init__(self, commits, height: int | None = None):
        """commits: list of 8-felt vk commits (np arrays or int lists).
        height: fixed leaf count (power of two) — membership-path LENGTH is
        baked into every join program, so registries that must share one
        program set (full lift+join enumeration) pin the height."""
        self.commits = [np.asarray(c, np.uint32).reshape(8) for c in commits]
        n = len(self.commits)
        assert n >= 1
        height = height or max(2, 1 << (n - 1).bit_length())
        assert height >= n and height & (height - 1) == 0
        mat = np.zeros((height, 8), dtype=np.uint32)
        for i, c in enumerate(self.commits):
            mat[i] = c
        self.tree = merkle.commit([mat])
        self._index = {c.tobytes(): i for i, c in enumerate(self.commits)}

    @property
    def root(self) -> np.ndarray:
        return self.tree.root

    @property
    def depth(self) -> int:
        return len(self.tree.levels) - 1

    def membership(self, commit):
        """(index, path digests) for a vk commit, or raises KeyError."""
        key = np.asarray(commit, np.uint32).reshape(8).tobytes()
        idx = self._index[key]
        rows, path = merkle.open_at(self.tree, idx)
        return idx, path

    def verify_membership(self, commit, idx: int, path) -> bool:
        height = self.tree.levels[0].shape[0]
        return merkle.verify_opening(
            self.root, [(height, 8)], idx,
            [np.asarray(commit, np.uint32)], path,
        )


def traced_membership(t, vk_handles8, root8, index: int, path):
    """In-circuit registry membership: the 8 vk handles hash to a leaf
    whose hinted path reaches `root8` (handles or consts). Index bits and
    sibling digests enter as hints (any valid opening convinces)."""
    bits = []
    for i in range(len(path)):
        b = t.hint((int(index) >> i) & 1)
        t.assert_eq(b * b, b)
        bits.append(b)
    path_h = [[t.hint(int(v)) for v in digest] for digest in path]
    traced_merkle_verify(t, list(vk_handles8), bits, path_h, list(root8))


def registry_for_lifts(machine, vk, shard_proofs, config=None, grid: int = 1):
    """Build the registry of lift vks reachable from these shard proofs'
    shapes: one SETUP-ONLY lift per DISTINCT shape (lift vks are
    input-independent, so no proving is needed to enumerate them)."""
    from .mips_pipeline import build_lift_registry

    return build_lift_registry(machine, vk, shard_proofs, config=config)
