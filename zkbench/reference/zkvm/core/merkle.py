"""Merkle-tree vector commitment over batches of matrices (host path).

Mirrors the structure of the reference's Poseidon2 Merkle MMCS
(reference: crates/stark/src/kb31_poseidon2.rs `ValMmcs = MerkleTreeMmcs<..>`):

  * commit a batch of (n_i, w_i) matrices with power-of-two heights;
  * leaf layer = row-hashes of all matrices of maximal height (rows of equal
    height concatenated before hashing, in batch order);
  * climbing the tree, whenever the current level height equals a shorter
    matrix's height, that matrix's row-hash is folded in:
        digest = compress(compress(left, right), hash(injected rows));
  * the commitment is the root digest (8 field elements);
  * opening index i yields, per matrix, row i >> (log_max - log_h), plus the
    sibling-digest path (with injected-row digests recomputed by the verifier).

The device path (ziren_tpu.ops.jmerkle) computes the same tree with leaf
hashing and level compression on TPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import poseidon2 as p2

DIGEST_WIDTH = 8


@dataclass
class MerkleTree:
    matrices: list  # list of (n_i, w_i) uint32 arrays (original order)
    levels: list  # levels[0] = leaf digests (max_h, 8), ..., last = (1, 8)

    @property
    def root(self) -> np.ndarray:
        return self.levels[-1][0]


def _rows_at_height(matrices, height):
    return [m for m in matrices if m.shape[0] == height]


def commit(matrices) -> MerkleTree:
    matrices = [np.ascontiguousarray(np.asarray(m, dtype=np.uint32)) for m in matrices]
    heights = sorted({m.shape[0] for m in matrices}, reverse=True)
    for h in heights:
        assert h & (h - 1) == 0, "matrix heights must be powers of two"
    max_h = heights[0]

    cur = _hash_rows_concat(_rows_at_height(matrices, max_h))
    levels = [cur]
    h = max_h
    while h > 1:
        h //= 2
        cur = p2.compress(cur[0::2], cur[1::2])
        inject = _rows_at_height(matrices, h)
        if inject:
            cur = p2.compress(cur, _hash_rows_concat(inject))
        levels.append(cur)
    return MerkleTree(matrices, levels)


def _hash_rows_concat(mats) -> np.ndarray:
    rows = np.concatenate(mats, axis=1) if len(mats) > 1 else mats[0]
    return p2.hash_rows(rows)


def open_at(tree: MerkleTree, index: int):
    """Open row `index` (of the tallest height): (rows per matrix, path)."""
    max_h = tree.levels[0].shape[0]
    log_max = max_h.bit_length() - 1
    rows = []
    for m in tree.matrices:
        log_h = m.shape[0].bit_length() - 1
        rows.append(m[index >> (log_max - log_h)].copy())
    path = []
    idx = index
    for lvl in tree.levels[:-1]:
        path.append(lvl[idx ^ 1].copy())
        idx >>= 1
    return rows, path


def verify_openings_batch(root, matrix_dims, indices, rows_list, paths_list) -> bool:
    """Batched verification of many openings against one commitment:
    leaf hashes and per-level compressions run vectorized across queries."""
    nq = len(indices)
    if nq == 0:
        return True
    heights = sorted({h for h, _ in matrix_dims}, reverse=True)
    max_h = heights[0]
    log_max = max_h.bit_length() - 1
    for path in paths_list:
        if len(path) != log_max:
            return False

    def rows_at(rows, h):
        return [
            np.asarray(r, np.uint32)
            for (hh, _), r in zip(matrix_dims, rows)
            if hh == h
        ]

    leaf = np.stack(
        [np.concatenate(rows_at(rows, max_h)) for rows in rows_list]
    )
    digests = p2.hash_rows(leaf)  # (nq, 8)
    idxs = np.asarray(indices, dtype=np.int64)
    h = max_h
    for lvl in range(log_max):
        siblings = np.stack([np.asarray(paths_list[q][lvl], np.uint32) for q in range(nq)])
        bits = (idxs & 1).astype(bool)
        left = np.where(bits[:, None], siblings, digests)
        right = np.where(bits[:, None], digests, siblings)
        digests = p2.compress(left, right)
        idxs >>= 1
        h //= 2
        if any(hh == h for hh, _ in matrix_dims):
            inj = np.stack(
                [np.concatenate(rows_at(rows, h)) for rows in rows_list]
            )
            digests = p2.compress(digests, p2.hash_rows(inj))
    want = np.asarray(root, np.uint32)
    return bool(np.all(digests == want[None, :]))


def verify_opening(root, matrix_dims, index: int, rows, path) -> bool:
    """matrix_dims: list of (height, width) in batch order."""
    heights = sorted({h for h, _ in matrix_dims}, reverse=True)
    max_h = heights[0]
    log_max = max_h.bit_length() - 1
    if len(path) != log_max:
        return False

    def rows_at(h):
        return [np.asarray(r, np.uint32) for (hh, _), r in zip(matrix_dims, rows) if hh == h]

    digest = p2.hash_iter(np.concatenate(rows_at(max_h)))
    idx = index
    h = max_h
    for sibling in path:
        left, right = (digest, sibling) if idx & 1 == 0 else (sibling, digest)
        digest = p2.compress(left, right)
        idx >>= 1
        h //= 2
        inj = rows_at(h)
        if inj:
            digest = p2.compress(digest, p2.hash_iter(np.concatenate(inj)))
    return bool(np.array_equal(digest, np.asarray(root, np.uint32)))
