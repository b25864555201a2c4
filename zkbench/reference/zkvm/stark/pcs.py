"""Two-adic FRI polynomial commitment scheme (host path).

Reproduces the structure of the reference's `TwoAdicFriPcs` + `FriConfig`
(reference: crates/stark/src/kb31_poseidon2.rs:17-65 — log_blowup=1,
84 queries, 16 PoW bits):

  * commit: per matrix, coset-LDE onto GENERATOR * H_(n<<blowup), stored
    bit-reversed, batch-committed in a Poseidon2 Merkle tree (core/merkle.py).
  * open: sample alpha; per LDE log-height accumulate the reduced opening
      ro_l(x) = sum alpha^k (y_{c,z} - m_c(x)) / (z - x)
    with a per-height running alpha counter; run the FRI commit phase
    (pair-commit, sample beta, fold by two, inject matching-height inputs),
    then PoW grinding and per-query Merkle openings of both the input batches
    and the fold layers.
  * verify: replay the transcript, recompute ro_l at each queried index from
    the opened rows and fold down to the final constant.

Indices address the bit-reversed arrays: entry j of a height-2^k array is the
evaluation at  shift * w_{2^k}^{rev_k(j)}.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import ext as E
from ..core import field as F
from ..core import merkle, ntt
from .domain import Domain, natural_domain_for_degree


@dataclass
class FriConfig:
    log_blowup: int = 1
    num_queries: int = 84
    proof_of_work_bits: int = 16


@dataclass
class ProverData:
    domains: list  # Domain per matrix (the *trace* domain the evals live on)
    mats: list  # original evals, natural order (n_i, w_i)
    coeffs: list  # monomial coefficients (n_i, w_i)
    ldes: list  # LDE evals over GENERATOR*H_(n<<blowup), natural order
    tree: merkle.MerkleTree  # commitment over bit-reversed LDEs

    @property
    def commit(self) -> np.ndarray:
        return self.tree.root


@dataclass
class CommitPhaseData:
    commits: list
    trees: list
    final_poly: np.ndarray  # (4,)


@dataclass
class QueryProof:
    input_openings: list  # per round: (rows, path)
    commit_phase_openings: list  # per layer: (pair (2,4) uint32, path)


@dataclass
class FriProof:
    commit_phase_commits: list  # roots
    query_proofs: list
    final_poly: np.ndarray
    pow_witness: int


def _bit_reverse_rows(m: np.ndarray) -> np.ndarray:
    n = m.shape[0]
    return m[F.bit_reverse_indices(n.bit_length() - 1)]


def _mod_matmul_base_ext_multi(mat: np.ndarray, ext_vecs: list) -> list:
    """(n, w) base @ each (w, 4) ext -> list of (n, 4). All right-hand
    sides share ONE 16-bit limb split of `mat` and ONE pair of BLAS
    matmuls (limb products < 2^32, sums over w < 2^21 stay < 2^53: exact).
    The prover opens every matrix at 2+ points (zeta, zeta_next), so
    batching the points halves the float conversions and matmul count."""
    assert mat.shape[1] < (1 << 21)
    a = mat.astype(np.uint64)
    k = len(ext_vecs)
    v = np.hstack([np.asarray(x, np.uint64) for x in ext_vecs])  # (w, 4k)
    p = np.uint64(F.P_INT)
    a_lo = (a & np.uint64(0xFFFF)).astype(np.float64)
    a_hi = (a >> np.uint64(16)).astype(np.float64)
    v_lo = (v & np.uint64(0xFFFF)).astype(np.float64)
    v_hi = (v >> np.uint64(16)).astype(np.float64)
    s00 = (a_lo @ v_lo).astype(np.uint64)
    s01 = (a_lo @ v_hi).astype(np.uint64)
    s10 = (a_hi @ v_lo).astype(np.uint64)
    s11 = (a_hi @ v_hi).astype(np.uint64)
    out = (
        s00 % p
        + (((s01 % p) << np.uint64(16)) % p)
        + (((s10 % p) << np.uint64(16)) % p)
        + (((s11 % p) << np.uint64(32)) % p)
    ) % p
    out = out.astype(np.uint32)
    return [out[:, 4 * i: 4 * i + 4] for i in range(k)]


def _mod_matmul_base_ext(mat: np.ndarray, ext_vec: np.ndarray) -> np.ndarray:
    """(n, w) base @ (w, 4) ext -> (n, 4)."""
    return _mod_matmul_base_ext_multi(mat, [ext_vec])[0]


class KbMmcs:
    """Default commitment layer: Poseidon2-KoalaBear Merkle (core/merkle.py),
    roots are 8 KoalaBear felts observed directly."""

    commit = staticmethod(merkle.commit)
    open_at = staticmethod(merkle.open_at)
    verify_openings_batch = staticmethod(merkle.verify_openings_batch)

    @staticmethod
    def num_leaves(tree) -> int:
        return tree.levels[0].shape[0]

    @staticmethod
    def observe_root(ch, root) -> None:
        ch.observe_slice(np.asarray(root, np.uint32))


class TwoAdicFriPcs:
    def __init__(self, fri: FriConfig, mmcs=None):
        self.fri = fri
        self.mmcs = mmcs or KbMmcs

    def natural_domain_for_degree(self, n: int) -> Domain:
        return natural_domain_for_degree(n)

    # -- commit ------------------------------------------------------------
    def commit(self, domains_and_mats):
        domains, mats, coeffs, ldes, brs = [], [], [], [], []
        for dom, m in domains_and_mats:
            m = np.asarray(m, dtype=np.uint32)
            assert m.shape[0] == dom.size
            # interpolate on the matrix's own domain, then evaluate over
            # GENERATOR * H_(n << blowup): lde_shift = GENERATOR / dom.shift
            c = ntt.intt(m)
            if dom.shift != 1:
                s_inv = pow(int(dom.shift), F.P_INT - 2, F.P_INT)
                c = F.fmul(c, F.powers(s_inv, c.shape[0])[:, None])
            # coefficients now in plain monomial basis; evaluate over g*H'
            lde = ntt.coset_eval(c, self.fri.log_blowup, F.GENERATOR)
            domains.append(dom)
            mats.append(m)
            coeffs.append(c)
            ldes.append(lde)
            brs.append(_bit_reverse_rows(lde))
        tree = self.mmcs.commit(brs)
        data = ProverData(domains, mats, coeffs, ldes, tree)
        return data.commit, data

    def get_evaluations_on_domain(self, data: ProverData, i: int, domain: Domain):
        """Committed LDE restricted to `domain` (must be a subset coset)."""
        lde = data.ldes[i]
        assert domain.shift == F.GENERATOR % F.P_INT
        stride = lde.shape[0] // domain.size
        assert stride >= 1 and lde.shape[0] % domain.size == 0
        return lde[::stride]

    # -- open --------------------------------------------------------------
    def open(self, rounds, challenger):
        """rounds: list of (ProverData, points_per_matrix) where
        points_per_matrix[i] is a list of ext points (4,) arrays.
        Returns (opened_values, FriProof)."""
        alpha = challenger.sample_ext()
        log_blowup = self.fri.log_blowup

        # opened values at all points
        opened_values = []
        for data, points_per_mat in rounds:
            round_vals = []
            for i, pts in enumerate(points_per_mat):
                mat_vals = ntt.eval_at_ext_points(data.coeffs[i], pts)
                round_vals.append(mat_vals)  # list over points of (w, 4)
            opened_values.append(round_vals)

        # reduced openings per LDE log-height, natural order
        ro: dict[int, np.ndarray] = {}
        cnt: dict[int, int] = {}
        inv_cache: dict = {}  # (l, z bytes) -> inv(z - x) over the domain
        for (data, points_per_mat), round_vals in zip(rounds, opened_values):
            for i, (pts, mat_vals) in enumerate(zip(points_per_mat, round_vals)):
                lde = data.ldes[i]
                l = lde.shape[0].bit_length() - 1
                if l not in ro:
                    ro[l] = E.ezero((1 << l,))
                    cnt[l] = 0
                w = lde.shape[1]
                per_point = []
                for z, ys in zip(pts, mat_vals):
                    # inv(z - x) vectorized over the domain (shared across
                    # every matrix of this height opened at the same point)
                    key = (l, np.asarray(z, np.uint32).tobytes())
                    inv_zmx = inv_cache.get(key)
                    if inv_zmx is None:
                        xs = F.fmul(
                            np.uint32(F.GENERATOR),
                            F.powers(F.two_adic_generator(l), 1 << l),
                        )
                        zmx = E.esub(
                            np.broadcast_to(z, (1 << l, 4)), E.from_base(xs)
                        )
                        inv_zmx = E.einv(zmx)
                        inv_cache[key] = inv_zmx
                    alpha_pows = E.epowers(alpha, cnt[l] + w)[cnt[l] :]  # (w,4)
                    per_point.append((ys, inv_zmx, alpha_pows))
                    cnt[l] += w
                # sum_c alpha^{cnt+c} (y_c - m_c(x)) =
                #   (sum_c alpha^c y_c) - lde @ alpha_pows  (mod-matmul);
                # all points of this matrix share one batched matmul
                m_terms = _mod_matmul_base_ext_multi(
                    lde, [ap for _, _, ap in per_point])
                for (ys, inv_zmx, alpha_pows), m_term in zip(
                        per_point, m_terms):
                    y_term = E.esum(E.emul(alpha_pows, ys), axis=0)  # (4,)
                    acc = E.esub(np.broadcast_to(y_term, (1 << l, 4)), m_term)
                    ro[l] = E.eadd(ro[l], E.emul(acc, inv_zmx))
        # FRI commit phase on bit-reversed reduced openings
        inputs = sorted(ro.items(), reverse=True)
        shifts = self._make_shifts(inputs[0][0])
        cp = self._commit_phase(
            [(l, _bit_reverse_rows(v)) for l, v in inputs], challenger, shifts
        )

        # PoW grind
        pow_witness = challenger.grind(self.fri.proof_of_work_bits)

        # queries
        log_max = inputs[0][0]
        query_indices = [
            challenger.sample_bits(log_max) for _ in range(self.fri.num_queries)
        ]
        query_proofs = []
        for idx in query_indices:
            input_openings = []
            for data, _pts in rounds:
                tree_log = self.mmcs.num_leaves(data.tree).bit_length() - 1
                rows, path = self.mmcs.open_at(data.tree, idx >> (log_max - tree_log))
                input_openings.append((rows, path))
            cp_openings = []
            i = idx
            for tree in cp.trees:
                row, path = self.mmcs.open_at(tree, i >> 1)
                pair = np.asarray(row[0], np.uint32).reshape(2, 4)
                cp_openings.append((pair, path))
                i >>= 1
            query_proofs.append(QueryProof(input_openings, cp_openings))

        proof = FriProof(cp.commits, query_proofs, cp.final_poly, pow_witness)
        return opened_values, proof

    def _commit_phase(self, inputs, challenger, shifts) -> CommitPhaseData:
        """inputs: [(log_height, bit-reversed ext array (2^l, 4))] desc."""
        log_blowup = self.fri.log_blowup
        it = iter(inputs)
        l, cur = next(it)
        nxt = next(it, None)
        commits, trees = [], []
        while cur.shape[0] > (1 << log_blowup):
            leaves = cur.reshape(-1, 8)  # (h/2, 2 ext) flattened to base
            tree = self.mmcs.commit([leaves])
            commits.append(tree.root)
            trees.append(tree)
            self.mmcs.observe_root(challenger, tree.root)
            beta = challenger.sample_ext()
            cur = self._fold(cur, beta, l, shifts)
            l -= 1
            if nxt is not None and nxt[0] == l:
                cur = E.eadd(cur, nxt[1])
                nxt = next(it, None)
        final = cur[0].copy()
        assert np.all(cur == final), "final polynomial is not constant"
        challenger.observe_slice(final)
        return CommitPhaseData(commits, trees, final)

    def _fold(self, e_br: np.ndarray, beta: np.ndarray, log_h: int, shifts) -> np.ndarray:
        """One fold of a bit-reversed ext array of height 2^log_h, coset shift
        GENERATOR^(2^k): entry pairs are (f(x), f(-x))."""
        half = (F.P_INT + 1) // 2
        lo = e_br[0::2]
        hi = e_br[1::2]
        m = 1 << (log_h - 1)
        shift = shifts[log_h]
        w_inv = pow(F.two_adic_generator(log_h), F.P_INT - 2, F.P_INT)
        s_inv = pow(shift, F.P_INT - 2, F.P_INT)
        xinv = F.fmul(np.uint32(s_inv), F.powers(w_inv, m))[
            F.bit_reverse_indices(log_h - 1)
        ]
        even = E.emul_base(E.eadd(lo, hi), np.uint32(half))
        odd = E.emul_base(E.emul_base(E.esub(lo, hi), np.uint32(half)), xinv)
        return E.eadd(even, E.emul(odd, np.broadcast_to(beta, odd.shape)))


    # -- verify ------------------------------------------------------------
    def verify(self, rounds, proof: FriProof, challenger) -> bool:
        """rounds: list of (commit, [(domain, [(z, ys (w,4))...])] per matrix)."""
        alpha = challenger.sample_ext()
        log_blowup = self.fri.log_blowup

        # replay commit phase
        betas = []
        for c in proof.commit_phase_commits:
            self.mmcs.observe_root(challenger, c)
            betas.append(challenger.sample_ext())
        challenger.observe_slice(np.asarray(proof.final_poly, np.uint32))
        if not challenger.check_witness(self.fri.proof_of_work_bits, proof.pow_witness):
            return False

        # heights
        heights = set()
        for _commit, mats in rounds:
            for dom, _pts in mats:
                heights.add(dom.log_n + log_blowup)
        log_max = max(heights)
        if len(proof.commit_phase_commits) != log_max - log_blowup:
            return False

        query_indices = [
            challenger.sample_bits(log_max) for _ in range(self.fri.num_queries)
        ]
        if len(proof.query_proofs) != len(query_indices):
            return False

        shifts = self._make_shifts(log_max)

        # batched Merkle verification across all queries
        for r_i, (commit, mats) in enumerate(rounds):
            dims = [(dom.size << log_blowup, len(pts[0][1])) for dom, pts in mats]
            tree_log = max(h for h, _ in dims).bit_length() - 1
            idxs, rows_l, paths_l = [], [], []
            for idx, qp in zip(query_indices, proof.query_proofs):
                if len(qp.input_openings) != len(rounds):
                    return False
                rows, path = qp.input_openings[r_i]
                idxs.append(idx >> (log_max - tree_log))
                rows_l.append(rows)
                paths_l.append(path)
            if not self.mmcs.verify_openings_batch(commit, dims, idxs, rows_l, paths_l):
                return False
        for l_i, commit in enumerate(proof.commit_phase_commits):
            layer_log = log_max - l_i
            idxs, rows_l, paths_l = [], [], []
            for idx, qp in zip(query_indices, proof.query_proofs):
                if len(qp.commit_phase_openings) != len(betas):
                    return False
                pair, path = qp.commit_phase_openings[l_i]
                idxs.append((idx >> l_i) >> 1)
                rows_l.append([np.asarray(pair, np.uint32).reshape(-1)])
                paths_l.append(path)
            if not self.mmcs.verify_openings_batch(
                commit, [(1 << (layer_log - 1), 8)], idxs, rows_l, paths_l
            ):
                return False

        return self._verify_queries(
            rounds, query_indices, proof.query_proofs, alpha, betas,
            proof.final_poly, log_max, shifts,
        )

    @staticmethod
    def _make_shifts(log_max: int) -> dict:
        """Coset shift per fold-layer height: the max-height layer lives on
        GENERATOR * H, and each fold squares the shift. Returned as a local
        dict (no instance state: one pcs object serves concurrent shard
        proofs)."""
        shifts = {}
        s = F.GENERATOR % F.P_INT
        for l in range(log_max, 0, -1):
            shifts[l] = s
            s = (s * s) % F.P_INT
        return shifts

    def _verify_queries(
        self, rounds, query_indices, query_proofs, alpha, betas, final_poly,
        log_max, shifts
    ) -> bool:
        """All queries verified together: reduced openings and the fold chain
        run as (nq, 4) vector ops instead of a Python loop per query (the
        84-query core config made the scalar path the verify bottleneck)."""
        log_blowup = self.fri.log_blowup
        nq = len(query_indices)
        idxs = np.asarray(query_indices, dtype=np.int64)
        for qp in query_proofs:
            if len(qp.input_openings) != len(rounds):
                return False
            if len(qp.commit_phase_openings) != len(betas):
                return False
        # 1. reduced openings per height, batched over queries
        ro: dict[int, np.ndarray] = {}
        cnt: dict[int, int] = {}
        for r_i, (_commit, mats) in enumerate(rounds):
            for m_i, (dom, pts) in enumerate(mats):
                l = dom.log_n + log_blowup
                if l not in ro:
                    ro[l] = E.ezero((nq,))
                    cnt[l] = 0
                i_l = idxs >> (log_max - l)
                g = F.two_adic_generator(l)
                x = np.array(
                    [
                        F.GENERATOR
                        * pow(g, F.reverse_bits_len(int(i), l), F.P_INT)
                        % F.P_INT
                        for i in i_l
                    ],
                    dtype=np.uint64,
                ) % np.uint64(F.P_INT)
                rows = np.stack(
                    [
                        np.asarray(qp.input_openings[r_i][0][m_i], np.uint32)
                        for qp in query_proofs
                    ]
                )  # (nq, w)
                w = rows.shape[1]
                for z, ys in pts:
                    inv_zmx = E.einv(
                        E.esub(
                            np.broadcast_to(z, (nq, 4)),
                            E.from_base(x.astype(np.uint32)),
                        )
                    )
                    alpha_pows = E.epowers(alpha, cnt[l] + w)[cnt[l] :]
                    y_term = E.esum(
                        E.emul(alpha_pows, np.asarray(ys, np.uint32)), axis=0
                    )
                    m_term = _mod_matmul_base_ext(rows, alpha_pows)  # (nq, 4)
                    acc = E.esub(np.broadcast_to(y_term, (nq, 4)), m_term)
                    ro[l] = E.eadd(ro[l], E.emul(acc, inv_zmx))
                    cnt[l] += w
        # 2. fold chain, batched over queries
        l = max(ro.keys())
        folded = ro[l]
        i = idxs.copy()
        half = np.uint32((F.P_INT + 1) // 2)
        for l_i, beta in enumerate(betas):
            pairs = np.stack(
                [
                    np.asarray(qp.commit_phase_openings[l_i][0], np.uint32).reshape(
                        2, 4
                    )
                    for qp in query_proofs
                ]
            )  # (nq, 2, 4)
            # current value must equal the opened entry at this index parity
            # (the Merkle paths were batch-verified above)
            sel = pairs[np.arange(nq), i & 1]
            if not np.array_equal(sel, folded):
                return False
            e0, e1 = pairs[:, 0], pairs[:, 1]
            g = F.two_adic_generator(l)
            x = np.array(
                [
                    shifts[l]
                    * pow(g, F.reverse_bits_len((int(ii) >> 1) << 1, l), F.P_INT)
                    % F.P_INT
                    for ii in i
                ],
                dtype=np.uint64,
            ) % np.uint64(F.P_INT)
            x_inv = F.finv(x.astype(np.uint32))  # (nq,)
            even = E.emul_base(E.eadd(e0, e1), half)
            odd = E.emul_base(E.emul_base(E.esub(e0, e1), half), x_inv)
            folded = E.eadd(even, E.emul(odd, np.broadcast_to(beta, (nq, 4))))
            i >>= 1
            l -= 1
            if l in ro:
                folded = E.eadd(folded, ro[l])
        if l != log_blowup:
            return False
        return bool(np.all(folded == np.asarray(final_poly, np.uint32)[None, :]))
