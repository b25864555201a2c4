"""Device-resident TwoAdicFriPcs pieces on torch tensors (counterpart of
ops/jpcs.py).

Mirrors the host PCS (stark/pcs.py) with every matrix on the device
as canonical int64:

  * commit: per (height, shift) group INTT -> coset scale/pad -> NTT ->
    bit-reverse, then a Poseidon2 Merkle MMCS over the batch;
  * open: z-power tables, opened values (column contractions), reduced
    openings, FRI folds, and per-query row / sibling-path gathers.

The challenger, proof-of-work grind and query sampling run on the device
too (ops/tchallenger.py, stark/tprover.py). Outputs are bit-identical to
the host path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..core import field as F
from . import tfield as tf
from . import tposeidon2 as tp2

P = tf.P


def bitrev_idx(log_n: int, device) -> torch.Tensor:
    return tf.const(("br", log_n), lambda: F.bit_reverse_indices(log_n), device)


def powers_dev(base: int, n: int, device) -> torch.Tensor:
    """(n,) tensor of base^i."""
    return tf.const(
        ("pow", int(base), n), lambda: F.powers(base, n).astype(np.int64), device
    )


# ---------------------------------------------------------------------------
# NTT / LDE
# ---------------------------------------------------------------------------


def _stage_tables(log_n: int, inverse: bool, device) -> list:
    n = 1 << log_n
    root = F.two_adic_generator(log_n)
    if inverse:
        root = pow(root, P - 2, P)
    out = []
    for stage in range(log_n):
        w_span = pow(root, n >> (stage + 1), P)
        out.append(powers_dev(w_span, 1 << stage, device))
    return out


def ntt_bitrev_in(x: torch.Tensor, log_n: int, inverse: bool = False) -> torch.Tensor:
    """DIT butterflies over the rows of (n, w): bit-reversed input ->
    natural-order output."""
    n = 1 << log_n
    w = x.shape[1]
    for stage, tw in enumerate(_stage_tables(log_n, inverse, x.device)):
        half = 1 << stage
        blocks = x.reshape(n // (2 * half), 2 * half, w)
        lo = blocks[:, :half]
        t = (blocks[:, half:] * tw[None, :, None]) % P
        x = torch.cat([lo + t, lo - t], dim=1).reshape(n, w) % P
    if inverse:
        x = (x * pow(n, P - 2, P)) % P
    return x


def lde(mat: torch.Tensor, log_n: int, added_bits: int, shift: int, dom_shift: int):
    """(n, w) evals over dom_shift*H -> (coeffs, lde natural, lde bitrev)
    over shift*H', |H'| = n << added_bits."""
    n = 1 << log_n
    dev = mat.device
    coeffs = ntt_bitrev_in(mat[bitrev_idx(log_n, dev)], log_n, inverse=True)
    if dom_shift != 1:
        # move off the source coset: plain monomial coefficients
        s_inv = pow(int(dom_shift), P - 2, P)
        coeffs = (coeffs * powers_dev(s_inv, n, dev)[:, None]) % P
    scaled = (coeffs * powers_dev(shift, n, dev)[:, None]) % P
    big_log = log_n + added_bits
    big = torch.zeros((n << added_bits, mat.shape[1]), dtype=torch.int64, device=dev)
    big[:n] = scaled
    br = bitrev_idx(big_log, dev)
    out = ntt_bitrev_in(big[br], big_log)
    return coeffs, out, out[br]


# ---------------------------------------------------------------------------
# Poseidon2 Merkle MMCS
# ---------------------------------------------------------------------------


@dataclass
class DTree:
    mats_br: list  # bit-reversed matrices, one per height (concatenated)
    levels: list  # (h, 8) digest levels, leaf -> root
    root: torch.Tensor  # (8,)
    # per mats_br entry: [(member_index, width)] -- how the height-grouped
    # matrix splits back into the batch's per-matrix openings (None = 1:1)
    members: list = None

    def layout(self):
        if self.members is not None:
            return tuple(tuple(g) for g in self.members)
        return tuple(((i, int(m.shape[1])),) for i, m in enumerate(self.mats_br))


def merkle_levels(mats_br: list) -> list:
    """Leaf hashes of the tallest matrices (concatenated), then per level a
    pair compression, with each shorter height's hashed rows injected. The
    levels above kernels.LEVELS_MAX_HEIGHT digests are one permute call
    each; the levels from there down to the root are one compress_levels
    call."""
    heights = sorted({int(m.shape[0]) for m in mats_br}, reverse=True)

    def rows_at(h):
        group = [m for m in mats_br if m.shape[0] == h]
        if not group:
            return None
        return torch.cat(group, dim=1) if len(group) > 1 else group[0]

    h = heights[0]
    cur = tp2.hash_rows(rows_at(h))
    levels = [cur]
    while h > kernels.LEVELS_MAX_HEIGHT:
        h //= 2
        cur = tp2.compress_pairs(cur)
        inj = rows_at(h)
        if inj is not None:
            cur = tp2.compress2(cur, tp2.hash_rows(inj))
        levels.append(cur)
    if h > 1:
        injected = {hh: tp2.hash_rows(rows_at(hh)) for hh in heights if hh < h}
        levels += tp2.compress_levels(cur, injected)
    return levels


def merkle_commit(mats_br: list, members=None) -> DTree:
    levels = merkle_levels(mats_br)
    return DTree(mats_br, levels, levels[-1][0], members)


# ---------------------------------------------------------------------------
# commit
# ---------------------------------------------------------------------------


class DevProverData:
    """Committed batch, stored height-grouped: all matrices of one (height,
    shift) are concatenated column-wise and extended by one LDE call.
    Per-matrix views are column slices."""

    def __init__(self, domains, widths, group_of, group_members,
                 group_coeffs, group_ldes, tree):
        self.domains = domains
        self.widths = widths
        self.group_of = group_of  # group_of[i] = (group index, col offset)
        self.group_members = group_members  # per group: [(mat index, w)]
        self.group_coeffs = group_coeffs  # per group: (n, W)
        self.group_ldes = group_ldes  # per group: (N, W)
        self.tree = tree

    @property
    def commit(self) -> torch.Tensor:
        return self.tree.root

    def coeff(self, i: int) -> torch.Tensor:
        g, off = self.group_of[i]
        return self.group_coeffs[g][:, off : off + self.widths[i]]

    def lde(self, i: int) -> torch.Tensor:
        g, off = self.group_of[i]
        return self.group_ldes[g][:, off : off + self.widths[i]]


def batch_layout(domains):
    """Height/shift grouping of a commit batch, tallest first (stable):
    [(key, [member indices])], shared by commit(), the tree gather and the
    open stage."""
    groups: dict = {}
    for i, dom in enumerate(domains):
        groups.setdefault((dom.log_n, dom.shift), []).append(i)
    keys = sorted(groups, key=lambda k: -k[0])
    return [(k, groups[k]) for k in keys]


def commit(domains_and_mats, log_blowup: int):
    """domains_and_mats: [(Domain, (n, w) tensor)]. Returns (root, data).

    The Merkle tree hashes one concatenated matrix per height with columns
    in batch order (the multi-matrix MMCS leaf layout); same-height groups
    with different coset shifts (quotient chunks) are re-interleaved by one
    column gather."""
    domains = [d for d, _m in domains_and_mats]
    widths = [int(m.shape[1]) for _d, m in domains_and_mats]
    layout = batch_layout(domains)
    group_of = [None] * len(domains)
    group_members, group_coeffs, group_ldes, brs = [], [], [], []
    for g, (_key, idxs) in enumerate(layout):
        off = 0
        mem = []
        for i in idxs:
            group_of[i] = (g, off)
            mem.append((i, widths[i]))
            off += widths[i]
        mats = [domains_and_mats[i][1] for i in idxs]
        big = mats[0] if len(mats) == 1 else torch.cat(mats, dim=1)
        dom = domains[idxs[0]]
        c, ext, br = lde(big, dom.log_n, log_blowup, F.GENERATOR % P, dom.shift)
        group_coeffs.append(c)
        group_ldes.append(ext)
        brs.append(br)
        group_members.append(mem)

    # tree input: per height, columns in ascending batch order
    tree_mats, tree_members = [], []
    seen = set()
    for key, _idxs in layout:
        h = key[0]
        if h in seen:
            continue
        seen.add(h)
        gs = [g2 for g2, (k2, _x) in enumerate(layout) if k2[0] == h]
        if len(gs) == 1:
            tree_mats.append(brs[gs[0]])
            tree_members.append(list(group_members[gs[0]]))
            continue
        flat = []  # (mat index, width, col offset in the concat)
        off = 0
        for g2 in gs:
            for i, w in group_members[g2]:
                flat.append((i, w, off))
                off += w
        cat = torch.cat([brs[g2] for g2 in gs], dim=1)
        flat.sort(key=lambda t: t[0])
        colperm = np.concatenate([np.arange(o, o + w) for _i, w, o in flat])
        tree_mats.append(cat[:, tf.index(colperm, cat.device)])
        tree_members.append([(i, w) for i, w, _o in flat])
    tree = merkle_commit(tree_mats, tree_members)
    data = DevProverData(domains, widths, group_of, group_members,
                         group_coeffs, group_ldes, tree)
    return data.commit, data


def evals_on_domain(data: DevProverData, i: int, domain) -> torch.Tensor:
    """Committed LDE restricted to a subset coset (natural order)."""
    ext = data.lde(i)
    assert domain.shift == F.GENERATOR % P
    stride = ext.shape[0] // domain.size
    assert stride >= 1 and ext.shape[0] % domain.size == 0
    return ext[::stride]


# ---------------------------------------------------------------------------
# contractions
# ---------------------------------------------------------------------------

# elements per temporary in the chunked contractions (2^24 int64 = 128 MiB)
_CHUNK_ELEMS = 1 << 24


def mat_ext_matmul(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """(n, w) base @ (w, 4) ext -> (n, 4). Column-chunked; each product is
    reduced before the sum, and the running sum stays below w * p."""
    n, w = mat.shape
    chunk = max(1, _CHUNK_ELEMS // max(4 * n, 1))
    acc = torch.zeros((n, 4), dtype=torch.int64, device=mat.device)
    for c0 in range(0, w, chunk):
        c1 = min(c0 + chunk, w)
        t = (mat[:, c0:c1, None] * vec[None, c0:c1, :]) % P  # (n, c, 4)
        acc += t.sum(1)
    return acc % P


def colwise_ext_contract(mat: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """(n, w) base, (n, 4) ext -> (w, 4): out[c] = sum_r mat[r, c] * zp[r].
    Row-chunked; the running sum stays below n * p."""
    n, w = mat.shape
    chunk = max(1, _CHUNK_ELEMS // max(4 * w, 1))
    acc = torch.zeros((w, 4), dtype=torch.int64, device=mat.device)
    for r0 in range(0, n, chunk):
        r1 = min(r0 + chunk, n)
        t = (mat[r0:r1, :, None] * zp[r0:r1, None, :]) % P  # (c, w, 4)
        acc += t.sum(0)
    return acc % P


def ext_one(device) -> torch.Tensor:
    return tf.const("ext_one", lambda: np.array([1, 0, 0, 0], np.int64), device)


def zpow_table(z: torch.Tensor, log_n: int) -> torch.Tensor:
    """(2^log_n, 4) table of z^i from a (4,) point, by doubling."""
    pows = ext_one(z.device)[None, :]
    cur = z
    for _ in range(log_n):
        pows = torch.cat([pows, tf.emul(pows, cur[None, :])], dim=0)
        cur = tf.emul(cur, cur)
    return pows


def epowers_rev(alpha: torch.Tensor, n: int) -> torch.Tensor:
    """(n, 4): [alpha^(n-1), ..., alpha^1, alpha^0] (the device counterpart
    of core.ext.epowers(alpha, n)[::-1])."""
    if n == 0:
        return torch.zeros((0, 4), dtype=torch.int64, device=alpha.device)
    return zpow_table(alpha, (n - 1).bit_length())[:n].flip(0)


def next_point(z: torch.Tensor, domain) -> torch.Tensor:
    """z * g_domain (Domain.next_point counterpart)."""
    return tf.emul_base(z, int(domain.generator))


# ---------------------------------------------------------------------------
# FRI
# ---------------------------------------------------------------------------


def fri_fold(e_br: torch.Tensor, beta: torch.Tensor, log_h: int, shift: int):
    """One fold of a bit-reversed ext (2^log_h, 4) array; beta (4,)."""
    lo = e_br[0::2]
    hi = e_br[1::2]
    m = 1 << (log_h - 1)

    def build_xinv():
        w_inv = pow(F.two_adic_generator(log_h), P - 2, P)
        s_inv = pow(shift, P - 2, P)
        xinv = (F.powers(w_inv, m).astype(np.int64) * s_inv) % P
        return xinv[F.bit_reverse_indices(log_h - 1)]

    xinv = tf.const(("fri_xinv", log_h, shift), build_xinv, e_br.device)
    half = (P + 1) // 2
    even = ((lo + hi) * half) % P
    odd = ((((lo - hi) % P) * half) % P * xinv[:, None]) % P
    return tf.madd(even, tf.emul(odd, beta))


# ---------------------------------------------------------------------------
# query gathers
# ---------------------------------------------------------------------------


def gather_tree_openings(tree: DTree, idxs: torch.Tensor, log_max_all: int):
    """Per-matrix opened rows and sibling paths for query indices.

    idxs index the globally tallest height (2^log_max_all); this tree's
    openings use idx >> (log_max_all - tree_log), exactly as the host
    pcs.open does. Height-grouped matrices split their rows back into the
    batch's per-matrix slices. Returns (rows per matrix, paths (nq, L, 8))."""
    layout = tree.layout()
    levels = tree.levels
    tree_log = int(levels[0].shape[0]).bit_length() - 1
    ti = idxs >> (log_max_all - tree_log)
    rows = [None] * sum(len(g) for g in layout)
    for m, group in zip(tree.mats_br, layout):
        log_h = int(m.shape[0]).bit_length() - 1
        grows = m[ti >> (tree_log - log_h)]  # (nq, W) grouped rows
        off = 0
        for member, w in group:
            rows[member] = grows[:, off : off + w]
            off += w
    path = []
    ii = ti
    for lvl in levels[:-1]:
        path.append(lvl[ii ^ 1])
        ii = ii >> 1
    if path:
        paths = torch.stack(path, dim=1)
    else:
        paths = torch.zeros((idxs.shape[0], 0, 8), dtype=torch.int64, device=idxs.device)
    return rows, paths
