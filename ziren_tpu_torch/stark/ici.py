"""Intra-proof sharding: ONE commit spread across the members of a mesh
(counterpart of stark/ici.py).

The data-parallel path (stark.machine.prove(devices=...)) gives each
member a whole shard; this module is the orthogonal axis: a SINGLE
shard's hot commit kernel, Poseidon2 Merkle leaf hashing, runs row-sharded
over a mesh, with the Merkle cap reduced across members by an all-gather
of per-member subtree roots, then the log2(N) top compress levels
computed redundantly on every member. Against one device the result is
bit-identical to tpcs.merkle_commit / core.merkle.commit: leaf hashing is
row-parallel and the tree's bottom log2(n/N) levels never cross a member
boundary.

A mesh (ziren_tpu_torch/device.py) is an ordered list of members, each a
device and, on CUDA, its own stream; several members may share one card.
Each member's kernels (K1 hash_rows, K2 permute above
kernels.LEVELS_MAX_HEIGHT digests, K3 compress_levels from there down) run
on its stream, and the exchanges between members are copies ordered by
stream waits (device.send): on one card a member reads the other's tensor
in place, between cards it is a peer copy. On CPU members the plain
versions run one member after the other.

Values are the port's canonical int64 in [0, p), not the JAX package's
Montgomery form. A row-sharded result is a tuple of per-member blocks in
member order (their concatenation is the JAX package's global array); a
replicated one is a tuple of one equal tensor per member. Every result is
ready for the caller's current stream on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import field as F
from ..device import Mesh, caller, send
from ..ops import tfield as tf
from ..ops import tmerkle, tpcs
from ..ops import tposeidon2 as tp2


def _scatter_rows(mat: torch.Tensor, mesh: Mesh) -> list:
    """The members' row blocks of `mat`, each readable on its member's
    stream."""
    n = int(mat.shape[0])
    if n % len(mesh):
        raise ValueError(f"{n} rows do not split over {len(mesh)} members")
    block = n // len(mesh)
    src = caller(mat)
    return [send(mat[m.index * block : (m.index + 1) * block], src, m) for m in mesh]


def _hand_back(parts: list, mesh: Mesh) -> tuple:
    """Per-member results, each made ready for the caller's current stream
    on its own device."""
    out = []
    for m, t in zip(mesh, parts):
        out.append(t if m.stream is None else send(t, m, caller(t)))
    return tuple(out)


def commit_row_sharded(mat: torch.Tensor, mesh: Mesh, axis: str = "row"):
    """Merkle commit of one bit-reversed canonical matrix (n, w), rows
    sharded over `mesh`'s `axis`. Returns (root, leaf_digests): the root,
    replicated, as one (8,) tensor per member, and the (n/N, 8) leaf digests
    of each member's block.

    n must be a power of two divisible by the mesh size; the per-member row
    block (n/N) must itself be a power of two >= 1.
    """
    mesh.check_axis(axis)
    n, n_dev = int(mat.shape[0]), len(mesh)
    if n % n_dev or n & (n - 1) or n_dev & (n_dev - 1):
        raise ValueError(f"{n} rows over {n_dev} members: both must be powers of two")
    block = n // n_dev
    local_levels = block.bit_length() - 1
    top_levels = n_dev.bit_length() - 1

    digests, subs = [], []
    for m, blk in zip(mesh, _scatter_rows(mat, mesh)):
        with m.scope():
            d = tp2.hash_rows(blk)  # (block, 8)
            digests.append(d)
            subs.append(tmerkle.compress_levels(d, local_levels))  # (1, 8) subtree root
    # the all-gather: every member takes every subtree root, folds the cap
    roots = []
    for m in mesh:
        with m.scope():
            caps = torch.cat([send(s, src, m) for src, s in zip(mesh, subs)])  # (N, 8)
            roots.append(tmerkle.compress_levels(caps, top_levels)[0])
    return _hand_back(roots, mesh), _hand_back(digests, mesh)


def leaf_hash_row_sharded(mat: torch.Tensor, mesh: Mesh, axis: str = "row") -> tuple:
    """Row-sharded leaf hashing only: (n, w) canonical -> the (n/N, 8)
    digests of each member's row block, each member hashing its own block
    (no traffic between members)."""
    mesh.check_axis(axis)
    out = []
    for m, blk in zip(mesh, _scatter_rows(mat, mesh)):
        with m.scope():
            out.append(tp2.hash_rows(blk))
    return _hand_back(out, mesh)


def _exchange(blocks: list, mesh: Mesh, split: int, cat: int) -> list:
    """The all-to-all of the four-step NTT (jax.lax.all_to_all, tiled):
    member d splits its block along axis `split` in N chunks and sends
    chunk c to member c, which concatenates what it receives along axis
    `cat`, in member order."""
    n_dev = len(mesh)
    out = []
    for dst in mesh:
        with dst.scope():
            pieces = []
            for src, b in zip(mesh, blocks):
                size = b.shape[split] // n_dev
                chunk = b.narrow(split, dst.index * size, size)
                pieces.append(send(chunk, src, dst))
            out.append(torch.cat(pieces, dim=cat))
    return out


def _twiddles(log_n: int, log_n1: int, n_dev: int, member) -> torch.Tensor:
    """Member `member`'s rows of the twiddle matrix w^(j2 k1), (n2/N, n1),
    sharded along j2, on its device (built once per device)."""
    n, n1 = 1 << log_n, 1 << log_n1
    n2 = n // n1
    rows = n2 // n_dev

    def build():
        j2 = np.arange(member.index * rows, (member.index + 1) * rows, dtype=np.int64)
        k1 = np.arange(n1, dtype=np.int64)
        pows = F.powers(F.two_adic_generator(log_n), n).astype(np.int64)
        return pows[np.outer(j2, k1) % n]  # canonical: reduced before any product

    return tf.const(("ntt_mesh_tw", log_n, n_dev, member.index), build, member.device)


def ntt_mesh(mat: torch.Tensor, mesh: Mesh, axis: str = "row") -> torch.Tensor:
    """Four-step NTT of (n, w) canonical coefficients over a mesh: local
    small NTTs and the butterfly TRANSPOSE exchanged between members (the
    JAX package's two all_to_all; the single-device cascade is
    ops/tntt.py).

    n = n1 * n2 with rows split j = j2 + n2*j1, j1 block-sharded:
      1. exchange -> each member holds full-j1 rows for its j2 chunk;
         local length-n1 NTTs:  U[j2, k1] = sum_j1 w^(n2 j1 k1) x[j2+n2 j1]
      2. twiddle  V = U * w^(j2 k1)   (the twiddle matrix sharded along j2)
      3. exchange back: k1 block-sharded, full j2 axis; local length-n2
         NTTs over j2:  W[k1, k2] = X[k1 + n1 k2]
    Returns the natural-order NTT (n, w) on the input's device, bit-identical
    to core/ntt.ntt. The local NTTs are tpcs.ntt_bitrev_in, in bit-reversed
    input order: eager PyTorch, no kernel of their own.
    """
    mesh.check_axis(axis)
    n, w = int(mat.shape[0]), int(mat.shape[1])
    n_dev = len(mesh)
    log_n = n.bit_length() - 1
    log_n1 = log_n // 2
    log_n2 = log_n - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    assert n1 % n_dev == 0 and n2 % n_dev == 0, "mesh must divide both axes"

    # (n1/N, n2, w) per member: its j1 block
    xs = [b.reshape(n1 // n_dev, n2, w) for b in _scatter_rows(mat, mesh)]
    a = _exchange(xs, mesh, split=1, cat=0)  # (n1, n2/N, w): full j1, its j2 chunk
    vs = []
    for m, blk in zip(mesh, a):
        with m.scope():
            br1 = tpcs.bitrev_idx(log_n1, m.device)
            # NTT over j1, the rows; every (j2, column) pair is a column
            u = tpcs.ntt_bitrev_in(blk.reshape(n1, -1)[br1], log_n1).reshape(n1, n2 // n_dev, w)
            tw = _twiddles(log_n, log_n1, n_dev, m)  # (n2/N, n1)
            vs.append((u * tw.t()[:, :, None]) % tf.P)  # (k1, j2 local, w)
    b = _exchange(vs, mesh, split=0, cat=1)  # (n1/N, n2, w): its k1 chunk, full j2
    outs = []
    for m, blk in zip(mesh, b):
        with m.scope():
            br2 = tpcs.bitrev_idx(log_n2, m.device)
            # NTT over j2: j2 first, every (k1, column) pair a column
            t = blk.transpose(0, 1).reshape(n2, -1)[br2]
            outs.append(tpcs.ntt_bitrev_in(t, log_n2).reshape(n2, n1 // n_dev, w))  # (k2, k1)
    # natural order: row k1 + n1 k2, each member's k1 chunk a slab of columns
    home = caller(mat)
    with home.scope():
        out = torch.empty((n2, n1, w), dtype=torch.int64, device=mat.device)
    for m, part in zip(mesh, outs):
        part = send(part, m, home)
        with home.scope():
            out[:, m.index * (n1 // n_dev) : (m.index + 1) * (n1 // n_dev)] = part
    return out.reshape(n, w)
