"""Merkle MMCS over BN254 digests for the outer (wrap) config.

Same batch/injection structure as core/merkle.py (mixed power-of-two
heights, shorter matrices folded in as the levels reach their height), but
leaves hash with the MultiField32 Poseidon2-BN254 sponge and nodes compress
with TruncatedPermutation<2,1,3>; a digest is ONE Fr element (reference:
crates/recursion/core/src/stark/config.rs OuterValMmcs, DIGEST_SIZE=1).

Matrix values stay KoalaBear u32; only digests live in Fr (python ints).
API mirrors core/merkle.py so the generic PCS can swap commitment layers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import bn254


@dataclass
class OuterMerkleTree:
    matrices: list  # (n_i, w_i) uint32 arrays, original order
    levels: list  # levels[0] = leaf digests [Fr]*max_h, ..., last = [root]

    @property
    def root(self) -> int:
        return self.levels[-1][0]


def _rows_at_height(matrices, height):
    return [m for m in matrices if m.shape[0] == height]


def _hash_rows_concat(mats) -> list:
    rows = np.concatenate(mats, axis=1) if len(mats) > 1 else mats[0]
    from . import bn254_native

    if bn254_native.available():
        return bn254_native.hash_rows(rows)
    return [bn254.hash_felts(rows[i]) for i in range(rows.shape[0])]


def _compress_level(cur: list) -> list:
    from . import bn254_native

    if len(cur) >= 32 and bn254_native.available():
        return bn254_native.compress_pairs(cur)
    return [bn254.compress(cur[2 * i], cur[2 * i + 1]) for i in range(len(cur) // 2)]


def commit(matrices) -> OuterMerkleTree:
    matrices = [
        np.ascontiguousarray(np.asarray(m, dtype=np.uint32)) for m in matrices
    ]
    heights = sorted({m.shape[0] for m in matrices}, reverse=True)
    for h in heights:
        assert h & (h - 1) == 0, "matrix heights must be powers of two"
    max_h = heights[0]

    cur = _hash_rows_concat(_rows_at_height(matrices, max_h))
    levels = [cur]
    h = max_h
    while h > 1:
        h //= 2
        cur = _compress_level(cur)
        inject = _rows_at_height(matrices, h)
        if inject:
            inj = _hash_rows_concat(inject)
            cur = [bn254.compress(c, d) for c, d in zip(cur, inj)]
        levels.append(cur)
    return OuterMerkleTree(matrices, levels)


def open_at(tree: OuterMerkleTree, index: int):
    max_h = len(tree.levels[0])
    log_max = max_h.bit_length() - 1
    rows = []
    for m in tree.matrices:
        log_h = m.shape[0].bit_length() - 1
        rows.append(m[index >> (log_max - log_h)].copy())
    path = []
    idx = index
    for lvl in tree.levels[:-1]:
        path.append(lvl[idx ^ 1])
        idx >>= 1
    return rows, path


def verify_openings_batch(root, matrix_dims, indices, rows_list, paths_list) -> bool:
    for idx, rows, path in zip(indices, rows_list, paths_list):
        if not verify_opening(root, matrix_dims, int(idx), rows, path):
            return False
    return True


def verify_opening(root, matrix_dims, index: int, rows, path) -> bool:
    heights = sorted({h for h, _ in matrix_dims}, reverse=True)
    max_h = heights[0]
    log_max = max_h.bit_length() - 1
    if len(path) != log_max:
        return False

    def rows_at(h):
        return [
            np.asarray(r, np.uint32)
            for (hh, _), r in zip(matrix_dims, rows)
            if hh == h
        ]

    digest = bn254.hash_felts(np.concatenate(rows_at(max_h)))
    idx = index
    h = max_h
    for sibling in path:
        sibling = int(sibling)
        left, right = (
            (digest, sibling) if idx & 1 == 0 else (sibling, digest)
        )
        digest = bn254.compress(left, right)
        idx >>= 1
        h //= 2
        inj = rows_at(h)
        if inj:
            digest = bn254.compress(
                digest, bn254.hash_felts(np.concatenate(inj))
            )
    return digest == int(root)
