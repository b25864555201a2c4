"""The outer (wrap) STARK verifier compiled to a BN254 R1CS — the circuit a
Groth16 proof attests (reference: crates/recursion/circuit/src/stark.rs
StarkVerifierCircuit + the gnark-ffi Go circuit; here built with the
in-house dual-field DSL, snark/circuit.py + circuit_outer.py).

`build_wrap_circuit(machine, vk, proof)` replays stark/verifier.py
verify_shard + stark/pcs.py TwoAdicFriPcs.verify value for value over
circuit wires:

  * public inputs: the wrap vk commitment (one Fr wire) followed by the
    proof's 8-felt RecursionPublicValues digest (canonical KoalaBear).
  * transcript: CircuitChallenger (Poseidon2-BN254 duplex) — vk, pv,
    commitments, cumulative sums, alpha/zeta, FRI betas, PoW check,
    query index bits.
  * commitment openings: single-Fr Merkle walks per round per query.
  * FRI: reduced openings with hinted (z - x)^-1, the fold chain, and
    the final-poly equality.
  * OOD: every chip's AIR + LogUp permutation constraints re-evaluated at
    zeta through `CircuitFolder` (the 7th folder) with Horner alpha
    folding, against the recomputed quotient.

Structural checks that depend only on the proof SHAPE (chip ordering,
width/shape checks) run at build time on the witness proof — the circuit
is deterministic per shape, like the reference's shape-fixed gnark
circuits. All data-dependent facts become constraints.
"""

from __future__ import annotations

import numpy as np

from ..core import ext as EH  # host ext (hint values only)
from ..core import field as FH
from ..stark.folder import _Builder
from . import circuit as C
from . import circuit_outer as CO
from .circuit import (
    CircuitBuilder,
    Ext,
    Felt,
    assert_ext_eq,
    assert_felt_zero,
    eadd,
    einv_hinted,
    emul,
    emul_base,
    esub,
    ext_const,
    ext_from_base,
    ext_select,
    ext_wit,
    fadd,
    felt_const,
    felt_select,
    felt_wit,
    finv_hinted,
    fmul,
    fscale,
    fsub,
)

P = FH.P_INT


# ---------------------------------------------------------------------------
# CircuitFolder — chip constraints over circuit values (the 7th folder)
# ---------------------------------------------------------------------------


class CFV:
    """Folder value wrapping a circuit Felt (base) or Ext."""

    __slots__ = ("fl", "v", "ext")

    def __init__(self, fl, v, ext):
        self.fl = fl
        self.v = v
        self.ext = ext

    def __add__(self, o):
        return self.fl._add(self, self.fl.lift(o))

    __radd__ = __add__

    def __sub__(self, o):
        return self.fl._sub(self, self.fl.lift(o))

    def __rsub__(self, o):
        return self.fl._sub(self.fl.lift(o), self)

    def __mul__(self, o):
        return self.fl._mul(self, self.fl.lift(o))

    __rmul__ = __mul__

    def __neg__(self):
        return self.fl._sub(self.fl.lift(0), self)


class CircuitFolder(_Builder):
    """VerifierFolder semantics with circuit arithmetic (stark/folder.py
    VerifierFolder is the host analogue; values are Ext openings)."""

    def __init__(self, bld, prep_local, prep_next, main_local, main_next,
                 sels, public_values, alpha, perm_challenges,
                 local_cumulative_sum, perm_local, perm_next,
                 global_cumulative_sum):
        _Builder.__init__(self)
        self.bld = bld
        mke = lambda vals: [CFV(self, v, True) for v in vals]
        self.prep_local = mke(prep_local)
        self.prep_next = mke(prep_next)
        self.main_local = mke(main_local)
        self.main_next = mke(main_next)
        self.public_values = [CFV(self, f, False) for f in public_values]
        self.is_first_row = CFV(self, sels["is_first_row"], True)
        self.is_last_row = CFV(self, sels["is_last_row"], True)
        self.is_transition = CFV(self, sels["is_transition"], True)
        self.alpha = alpha  # Ext
        self.acc = ext_const(bld, [0, 0, 0, 0])
        self.perm_challenges = tuple(
            CFV(self, c, True) for c in perm_challenges
        )
        self.local_cumulative_sum = CFV(self, local_cumulative_sum, True)
        self.global_cumulative_sum = [
            CFV(self, f, False) for f in global_cumulative_sum
        ]
        self._perm_local = mke(perm_local)
        self._perm_next = mke(perm_next)
        self._beta_pows: list = []

    def perm_columns(self, width):
        assert len(self._perm_local) == width
        return self._perm_local, self._perm_next

    def beta_power(self, j):
        """beta^(j+1) as a reduced cached CFV (permutation.py rlc chains:
        value j carries coefficient beta^(j+1))."""
        from .circuit import ext_reduce

        if not self._beta_pows:
            self._beta_pows.append(self.perm_challenges[1])
        while len(self._beta_pows) <= j:
            self._beta_pows.append(CFV(
                self,
                ext_reduce(emul(self._as_ext(self._beta_pows[-1]),
                                self._as_ext(self.perm_challenges[1]))),
                True,
            ))
        return self._beta_pows[j]

    def lift(self, x):
        if isinstance(x, CFV):
            return x
        return CFV(self, felt_const(self.bld, int(x) % P), False)

    def _as_ext(self, v) -> Ext:
        return v.v if v.ext else ext_from_base(v.v)

    def _add(self, a, b):
        if a.ext or b.ext:
            return CFV(self, eadd(self._as_ext(a), self._as_ext(b)), True)
        return CFV(self, fadd(a.v, b.v), False)

    def _sub(self, a, b):
        if a.ext or b.ext:
            return CFV(self, esub(self._as_ext(a), self._as_ext(b)), True)
        return CFV(self, fsub(a.v, b.v), False)

    def _mul(self, a, b):
        if a.ext and b.ext:
            return CFV(self, emul(a.v, b.v), True)
        if a.ext:
            return CFV(self, emul_base(a.v, b.v), True)
        if b.ext:
            return CFV(self, emul_base(b.v, a.v), True)
        return CFV(self, fmul(a.v, b.v), False)

    def _fold(self, e):
        self.acc = eadd(emul(self.acc, self.alpha), self._as_ext(e))


# ---------------------------------------------------------------------------
# ext helpers over circuit values
# ---------------------------------------------------------------------------


def _ext_pow2k(x: Ext, k: int) -> Ext:
    """x^(2^k) by squaring, components re-reduced each step (otherwise the
    doubling bound forces far costlier mid-chain reductions)."""
    for _ in range(k):
        x = C.ext_reduce(emul(x, x))
    return x


def _ext_sum(vals):
    acc = vals[0]
    for v in vals[1:]:
        acc = eadd(acc, v)
    return acc


def _mul_monomial(e: Ext, k: int) -> Ext:
    """e * X^k (x^4 = 3) — pure coefficient shuffle, no constraints."""
    if k == 0:
        return e
    out = [None] * 4
    for i in range(4):
        j = i + k
        if j < 4:
            out[j] = e.c[i]
        else:
            out[j - 4] = fscale(e.c[i], 3)
    return Ext(out)


def _combine_monomials(exts) -> Ext:
    """sum_e exts[e] * X^e (host verifier.py _unflatten semantics)."""
    acc = exts[0]
    for e in range(1, len(exts)):
        acc = eadd(acc, _mul_monomial(exts[e], e))
    return acc


def _zp_at(bld, dom, zeta: Ext) -> Ext:
    """(zeta / shift)^n - 1 in-circuit (stark/domain.py zp_at_point)."""
    shift_inv = pow(int(dom.shift), P - 2, P)
    zs = emul_base(zeta, felt_const(bld, shift_inv))
    return esub(_ext_pow2k(zs, dom.log_n), ext_const(bld, [1, 0, 0, 0]))


def _selectors_at(bld, dom, zeta: Ext) -> dict:
    shift_inv = pow(int(dom.shift), P - 2, P)
    unshifted = emul_base(zeta, felt_const(bld, shift_inv))
    one = ext_const(bld, [1, 0, 0, 0])
    z_h = esub(_ext_pow2k(unshifted, dom.log_n), one)
    g_inv = pow(dom.generator, P - 2, P)
    first = emul(z_h, einv_hinted(esub(unshifted, one)))
    last = emul(
        z_h, einv_hinted(esub(unshifted, ext_const(bld, [g_inv, 0, 0, 0])))
    )
    trans = esub(unshifted, ext_const(bld, [g_inv, 0, 0, 0]))
    return {
        "is_first_row": first,
        "is_last_row": last,
        "is_transition": trans,
        "inv_zeroifier": einv_hinted(z_h),
    }


def _wit_ext(bld, vals) -> Ext:
    return ext_wit(bld, np.asarray(vals, np.uint32).reshape(-1),
                   canon_in=False)


def _wit_exts(bld, vals_list):
    """Opened values: list of (4,) ext arrays -> list of Ext wits."""
    return [_wit_ext(bld, v) for v in vals_list]


def _wit_felts(bld, vals, canon=False):
    return [felt_wit(bld, int(v), canon=canon)
            for v in np.asarray(vals, np.uint32).reshape(-1)]


def _pow_from_bits(bld, g: int, bits, nbits: int) -> Felt:
    """g^(reverse_bits_len(index, nbits)) from LE index bits: index bit j
    contributes exponent 2^(nbits-1-j) (pcs.py reverse_bits_len walk)."""
    acc = felt_const(bld, 1)
    one = felt_const(bld, 1)
    for j in range(nbits):
        factor = felt_const(bld, pow(g, 1 << (nbits - 1 - j), P))
        acc = fmul(acc, felt_select(bits[j], factor, one))
    return acc


# ---------------------------------------------------------------------------
# the wrap verifier circuit
# ---------------------------------------------------------------------------


def build_wrap_circuit(machine, vk, proof):
    """Compile `verify_shard(machine, vk, proof)` (outer config) to an R1CS.

    Returns (builder, public_inputs): public_inputs = [vk_commit (Fr),
    pv_0..pv_7 (canonical KoalaBear)]. The builder's witness satisfies the
    system iff the supplied proof verifies; rebuilding with a different
    same-shape proof yields the same constraint system with fresh wires.
    """
    from ..stark.verifier import verify_shard

    config = machine.config
    pcs = config.pcs
    fri = pcs.fri

    # host-verify first: all structural/shape checks + honest witness
    host_ch = config.challenger()
    vk.observe_into(host_ch)
    verify_shard(machine, vk, proof, host_ch)

    bld = CircuitBuilder()
    vk_commit = bld.public(int(vk.commit))
    pv_pub = [C.felt_public(bld, int(v)) for v in proof.public_values]
    for f in pv_pub:
        C._checked_public_felt_range(bld, f)

    chips = [machine.chip_by_name[n] for n in proof.chip_names]

    # -- witness allocation ---------------------------------------------------
    main_root = bld.wit(int(proof.commitment.main))
    perm_root = bld.wit(int(proof.commitment.permutation))
    quot_root = bld.wit(int(proof.commitment.quotient))

    opened = []
    for chip, vals in zip(chips, proof.opened_values):
        opened.append({
            "prep_local": _wit_exts(bld, vals.preprocessed.local),
            "prep_next": _wit_exts(bld, vals.preprocessed.next),
            "main_local": _wit_exts(bld, vals.main.local),
            "main_next": _wit_exts(bld, vals.main.next),
            "perm_local": _wit_exts(bld, vals.permutation.local),
            "perm_next": _wit_exts(bld, vals.permutation.next),
            "quotient": [_wit_exts(bld, chunk) for chunk in vals.quotient],
            "local_sum": _wit_ext(bld, vals.local_cumulative_sum),
            "global_sum": _wit_felts(bld, vals.global_cumulative_sum),
        })

    # -- transcript (verify_shard order) ---------------------------------------
    ch = CO.CircuitChallenger(bld)
    CO.c_observe_vk(bld, ch, vk_commit, vk.extra_observations)
    ch.observe_slice(pv_pub)
    ch.observe_fr(main_root)
    perm_challenges = (ch.sample_ext(), ch.sample_ext())
    ch.observe_fr(perm_root)
    for chip, o in zip(chips, opened):
        ch.observe_slice(o["local_sum"].c)
        ch.observe_slice(o["global_sum"])
        if chip.commit_scope.name == "Local":
            for f in o["global_sum"]:
                assert_felt_zero(f)
        if chip.num_lookups == 0:
            for f in o["local_sum"].c:
                assert_felt_zero(f)
    alpha = ch.sample_ext()
    ch.observe_fr(quot_root)
    zeta = ch.sample_ext()

    trace_domains = [
        pcs.natural_domain_for_degree(1 << v.log_degree)
        for v in proof.opened_values
    ]

    def z_next(dom):
        return emul_base(zeta, felt_const(bld, dom.generator))

    # -- PCS rounds: (commit Var, [(dom, [(z Ext, ys [Ext])...])]) -------------
    chip_ordering = proof.chip_ordering
    prep_round = []
    for name, dom, dims, local_only in vk.chip_information:
        o = opened[chip_ordering[name]]
        pts = [(zeta, o["prep_local"])]
        if not local_only:
            pts.append((z_next(dom), o["prep_next"]))
        prep_round.append((dom, pts))
    main_round = []
    for chip, dom, o in zip(chips, trace_domains, opened):
        pts = [(zeta, o["main_local"])]
        if not chip.local_only:
            pts.append((z_next(dom), o["main_next"]))
        main_round.append((dom, pts))
    perm_round = [
        (dom, [(zeta, o["perm_local"]), (z_next(dom), o["perm_next"])])
        for dom, o in zip(trace_domains, opened)
    ]
    quotient_round = []
    qc_domains_per_chip = []
    for chip, dom, o in zip(chips, trace_domains, opened):
        qdom = dom.create_disjoint_domain(
            1 << (dom.log_n + chip.log_quotient_degree)
        )
        qc_domains = qdom.split_domains(chip.quotient_degree)
        qc_domains_per_chip.append(qc_domains)
        for sub_dom, chunk in zip(qc_domains, o["quotient"]):
            quotient_round.append((sub_dom, [(zeta, chunk)]))

    rounds = []
    if vk.chip_information:
        rounds.append((bld.const(int(vk.commit)), prep_round))
    rounds += [
        (main_root, main_round),
        (perm_root, perm_round),
        (quot_root, quotient_round),
    ]

    _fri_verify(bld, ch, fri, rounds, proof.opening_proof)

    # -- OOD constraint evaluation at zeta --------------------------------------
    for chip, dom, qc_domains, o in zip(
        chips, trace_domains, qc_domains_per_chip, opened
    ):
        sels = _selectors_at(bld, dom, zeta)
        quotient = _recompute_quotient(bld, o["quotient"], qc_domains, zeta)
        ezero = ext_const(bld, [0, 0, 0, 0])
        folder = CircuitFolder(
            bld,
            prep_local=o["prep_local"],
            prep_next=o["prep_next"] if o["prep_next"]
            else [ezero] * chip.preprocessed_width,
            main_local=o["main_local"],
            main_next=o["main_next"] if o["main_next"]
            else [ezero] * chip.width,
            sels=sels,
            public_values=pv_pub,
            alpha=alpha,
            perm_challenges=perm_challenges,
            local_cumulative_sum=o["local_sum"],
            perm_local=_combine_groups(o["perm_local"]),
            perm_next=_combine_groups(o["perm_next"]),
            global_cumulative_sum=o["global_sum"],
        )
        chip.eval_with_perm(folder)
        folded = emul(folder.acc, sels["inv_zeroifier"])
        assert_ext_eq(folded, quotient)

    # -- cross-chip local cumulative sum vanishes --------------------------------
    total = opened[0]["local_sum"]
    for o in opened[1:]:
        total = eadd(total, o["local_sum"])
    for f in total.c:
        assert_felt_zero(f)

    return bld, [int(vk.commit)] + [int(v) % P for v in proof.public_values]


def _combine_groups(ext_openings):
    """Perm columns: groups of 4 ext openings -> one Ext per perm column
    (host verifier.py _unflatten, constraint-free monomial shuffle)."""
    return [
        _combine_monomials(ext_openings[4 * c : 4 * c + 4])
        for c in range(len(ext_openings) // 4)
    ]


def _fri_verify(bld, ch, fri, rounds, proof):
    """TwoAdicFriPcs.verify in-circuit (stark/pcs.py:290-465, scalar form)."""
    alpha = ch.sample_ext()
    log_blowup = fri.log_blowup

    betas = []
    for c_root in proof.commit_phase_commits:
        root = bld.wit(int(c_root))
        ch.observe_fr(root)
        betas.append((ch.sample_ext(), root))
    final_poly = ext_wit(bld, np.asarray(proof.final_poly, np.uint32),
                         canon_in=True)
    ch.observe_slice(list(final_poly.c))
    ch.check_witness(fri.proof_of_work_bits,
                     felt_wit(bld, int(proof.pow_witness)))

    heights = set()
    for _c, mats in rounds:
        for dom, _pts in mats:
            heights.add(dom.log_n + log_blowup)
    log_max = max(heights)
    assert len(proof.commit_phase_commits) == log_max - log_blowup
    assert len(proof.query_proofs) == fri.num_queries

    query_bits = [ch.sample_bits(log_max) for _ in range(fri.num_queries)]

    # Merkle openings: per round tree and per commit-phase layer, per query
    circuit_rows = [dict() for _ in proof.query_proofs]
    circuit_pairs = [dict() for _ in proof.query_proofs]
    for r_i, (commit, mats) in enumerate(rounds):
        dims = [(dom.size << log_blowup, len(pts[0][1]))
                for dom, pts in mats]
        tree_log = max(h for h, _ in dims).bit_length() - 1
        for q_i, (bits, qp) in enumerate(zip(query_bits, proof.query_proofs)):
            rows, path = qp.input_openings[r_i]
            row_felts = [_wit_felts(bld, r) for r in rows]
            path_vars = [bld.wit(int(s)) for s in path]
            CO.c_verify_merkle_opening(
                bld, commit, dims, bits[log_max - tree_log:],
                row_felts, path_vars,
            )
            circuit_rows[q_i][r_i] = row_felts
    for l_i, (_beta, root) in enumerate(betas):
        layer_log = log_max - l_i
        for q_i, (bits, qp) in enumerate(zip(query_bits, proof.query_proofs)):
            pair, path = qp.commit_phase_openings[l_i]
            pair_felts = _wit_felts(
                bld, np.asarray(pair, np.uint32).reshape(-1)
            )
            path_vars = [bld.wit(int(s)) for s in path]
            CO.c_verify_merkle_opening(
                bld, root, [(1 << (layer_log - 1), 8)],
                bits[l_i + 1:], [pair_felts], path_vars,
            )
            circuit_pairs[q_i][l_i] = pair_felts

    # reduced openings (pcs.py _verify_queries step 1, scalar per query).
    # Per (matrix, point) the alpha-weighted sums run as HORNER chains and
    # one scale by alpha^base_cnt at the end: sum_i a^(b+i) v_i =
    # a^b * Horner(v) — this needs only one reduced power per point group
    # instead of a 2000-entry power table whose big-bound entries would
    # re-pay reduction at every use.
    ext_one = ext_const(bld, [1, 0, 0, 0])
    pow_w_cache: dict[int, Ext] = {}

    def alpha_to(w):
        """alpha^w by square-and-multiply, components kept reduced."""
        if w not in pow_w_cache:
            acc = None
            sq = alpha
            ww = w
            while ww:
                if ww & 1:
                    acc = sq if acc is None else C.ext_reduce(emul(acc, sq))
                ww >>= 1
                if ww:
                    sq = C.ext_reduce(emul(sq, sq))
            pow_w_cache[w] = acc if acc is not None else ext_one
        return pow_w_cache[w]

    # alpha^{cnt[l]} as a running product per height (cnt[l] is monotone)
    height_power: dict[int, Ext] = {}

    # radix-4 Horner: process 4 entries per outer step so the bound-driven
    # reductions amortize over 4 terms instead of 1 (alpha^1..3 reduced once)
    alpha2 = C.ext_reduce(emul(alpha, alpha))
    alpha3 = C.ext_reduce(emul(alpha2, alpha))
    alpha4 = C.ext_reduce(emul(alpha2, alpha2))
    a_small = [None, alpha, alpha2, alpha3]

    def horner(vals_ext):
        """sum_i alpha^i v_i (low index = low power)."""
        groups = [vals_ext[i : i + 4] for i in range(0, len(vals_ext), 4)]
        acc = None
        for g in reversed(groups):
            inner = g[0]
            for j in range(1, len(g)):
                inner = eadd(inner, emul(a_small[j], g[j]))
            acc = inner if acc is None else eadd(emul(acc, alpha4), inner)
        return acc

    def horner_base(rows):
        groups = [rows[i : i + 4] for i in range(0, len(rows), 4)]
        acc = None
        for g in reversed(groups):
            inner = ext_from_base(g[0])
            for j in range(1, len(g)):
                inner = eadd(inner, emul_base(a_small[j], g[j]))
            acc = inner if acc is None else eadd(emul(acc, alpha4), inner)
        return acc

    nq = len(query_bits)
    ro = [dict() for _ in range(nq)]
    cnt: dict[int, int] = {}
    for r_i, (_commit, mats) in enumerate(rounds):
        for m_i, (dom, pts) in enumerate(mats):
            l = dom.log_n + log_blowup
            # x per query depends only on the height l: share across points
            xs = []
            for bits in query_bits:
                idx_bits = bits[log_max - l:]
                xs.append(fmul(
                    felt_const(bld, FH.GENERATOR % P),
                    _pow_from_bits(bld, FH.two_adic_generator(l),
                                   idx_bits, l),
                ))
            for z, ys in pts:
                w = len(ys)
                base_cnt = cnt.get(l, 0)
                scale = height_power.get(l, ext_one)
                y_h = horner(ys)
                for q_i in range(nq):
                    inv_zmx = einv_hinted(esub(z, ext_from_base(xs[q_i])),
                                          canon_in=False)
                    rows = circuit_rows[q_i][r_i][m_i]
                    m_h = horner_base(rows)
                    acc = emul(emul(esub(y_h, m_h), scale), inv_zmx)
                    prev = ro[q_i].get(l)
                    ro[q_i][l] = acc if prev is None else eadd(prev, acc)
                cnt[l] = base_cnt + w
                height_power[l] = C.ext_reduce(emul(scale, alpha_to(w)))

    # fold chain (step 2, scalar per query)
    shifts = {}
    s = FH.GENERATOR % P
    for lv in range(log_max, 0, -1):
        shifts[lv] = s
        s = (s * s) % P
    half = (P + 1) // 2
    zero_bit = bld.const(0)
    for q_i, bits in enumerate(query_bits):
        l = max(ro[q_i].keys())
        folded = ro[q_i][l]
        for l_i, (beta, _root) in enumerate(betas):
            pair_felts = circuit_pairs[q_i][l_i]
            e0 = Ext(pair_felts[0:4])
            e1 = Ext(pair_felts[4:8])
            parity = bits[l_i]
            sel = ext_select(parity, e1, e0)
            assert_ext_eq(sel, folded)
            # x = shifts[l] * g^rev(((i >> 1) << 1), l): the pair base index
            # has a zero low bit; higher bits are the query bits above l_i
            ebits = [zero_bit] + bits[l_i + 1 : l_i + l]
            x = fmul(felt_const(bld, shifts[l]),
                     _pow_from_bits(bld, FH.two_adic_generator(l), ebits, l))
            x_inv = finv_hinted(x)
            even = emul_base(eadd(e0, e1), felt_const(bld, half))
            odd = emul_base(
                emul_base(esub(e0, e1), felt_const(bld, half)), x_inv
            )
            folded = eadd(even, emul(odd, beta))
            l -= 1
            if l in ro[q_i]:
                folded = eadd(folded, ro[q_i][l])
        assert l == log_blowup
        assert_ext_eq(folded, final_poly)


def _recompute_quotient(bld, quotient_chunks, qc_domains, zeta):
    """verifier.py _recompute_quotient over circuit values (the per-chunk
    Lagrange-style zp ratios; denominators are host constants)."""
    zps = []
    for i, dom in enumerate(qc_domains):
        acc = ext_const(bld, [1, 0, 0, 0])
        for j, other in enumerate(qc_domains):
            if j == i:
                continue
            num = _zp_at(bld, other, zeta)
            den_host = other.zp_at_point(dom.first_point())
            den_inv = EH.einv(np.asarray(den_host, np.uint32))
            acc = emul(acc, emul(num, ext_const(bld, den_inv)))
        zps.append(acc)
    total = ext_const(bld, [0, 0, 0, 0])
    for zp, chunk in zip(zps, quotient_chunks):
        part = _combine_monomials(chunk)
        total = eadd(total, emul(zp, part))
    return total
