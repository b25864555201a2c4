"""Poseidon2 Merkle commitment of one matrix on torch tensors (counterpart
of ops/jmerkle.py; the device counterpart of the host's core/merkle.py for
a single power-of-two-height matrix).

Canonical int64 in, canonical int64 out; the device is the tensor's. On a
CUDA tensor the leaf hashes are one launch of the hand-written row sponge
(kernels.hash_rows), the tall levels one permutation launch each
(kernels.permute), and the levels from kernels.LEVELS_MAX_HEIGHT digests
down to the root one launch (kernels.compress_levels); on a CPU tensor the
plain PyTorch versions of ops/tposeidon2.py run. Digests are bit-identical
to the host tree's.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import tpcs
from . import tposeidon2 as tp2


def leaf_hashes(mat: torch.Tensor) -> torch.Tensor:
    """(n, w) matrix -> (n, 8) leaf digests."""
    return tp2.hash_rows(mat)


def merkle_root(mat: torch.Tensor) -> torch.Tensor:
    """(n, w) matrix -> (8,) root digest (n a power of two)."""
    return tpcs.merkle_levels([mat])[-1][0]


def compress_levels(digests: torch.Tensor, levels: int) -> torch.Tensor:
    """Fold `levels` compress levels: (n, 8) -> (n >> levels, 8). A fold
    that ends at the root takes its last levels in one compress_levels call,
    as a tree does; one that stops above the root goes level by level."""
    n = digests.shape[0]
    to_root = levels > 0 and n >> levels == 1
    while levels and not (to_root and n <= kernels.LEVELS_MAX_HEIGHT):
        digests = tp2.compress_pairs(digests)
        n //= 2
        levels -= 1
    if levels:
        digests = tp2.compress_levels(digests, {})[-1]
    return digests
