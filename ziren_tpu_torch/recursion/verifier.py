"""Traced verifier building blocks (reference: crates/recursion/circuit —
the in-circuit Merkle/challenger/FRI components; written against the DSL
so they prove on the recursion machine)."""

from __future__ import annotations

import numpy as np

from .dsl import Felt, Tracer


def traced_compress(t: Tracer, left8, right8):
    """TruncatedPermutation 2-to-1 over two 8-felt digests."""
    return t.poseidon2(list(left8) + list(right8))[:8]


def traced_hash_rows(t: Tracer, felts):
    """PaddingFreeSponge over a flat felt list (rate 8)."""
    state = [t.const(0) for _ in range(16)]
    for i in range(0, len(felts), 8):
        chunk = felts[i : i + 8]
        state = chunk + state[len(chunk):]
        state = t.poseidon2(state)
    return state[:8]


def traced_merkle_verify(t: Tracer, leaf_felts, index_bits, path, root8):
    """Recompute a Merkle root from an opened row, sibling path and index
    bits (all DSL handles); asserts equality with `root8`
    (mirrors core/merkle.py verify_opening for a single matrix)."""
    digest = traced_hash_rows(t, list(leaf_felts))
    for bit, sibling in zip(index_bits, path):
        left = t.select8(bit, sibling, digest)
        right = t.select8(bit, digest, sibling)
        digest = traced_compress(t, left, right)
    for d, r in zip(digest, root8):
        t.assert_eq(d, r)
    return digest


def _ext(t, felts4):
    return t.ext_from(felts4)


def _ext_from_base(t, felt):
    z = t.const(0)
    return t.ext_from([felt, z, z, z])


def _ezero(t):
    z = getattr(t, "_ezero", None)
    if z is None:
        z = t._ezero = t.ext_const([0, 0, 0, 0])
    return z


def _assert_ext_eq(t, a, b):
    from .dsl import Felt

    for i in range(4):
        t.assert_eq(Felt(t, a.r + i), Felt(t, b.r + i))


def traced_pow_by_bits(t: Tracer, base: int, bits, reverse: bool):
    """g^rev(i) (reverse=True) or g^i as a Felt, from index bit handles:
    product of select(bit_j, g^(2^k_j), 1) with constant squares of g."""
    from ..core import field as F

    if len(bits) >= 2:
        return t.exp_rev_bits(int(base), bits, reverse=reverse)
    acc = t.const(1)
    n = len(bits)
    for j, bit in enumerate(bits):
        k = (n - 1 - j) if reverse else j
        c = pow(int(base), 1 << k, F.P_INT)
        acc = acc * t.select(bit, t.const(c), t.const(1))
    return acc


def _ext(t, felts4):
    return t.ext_from(felts4)


def _ext_from_base(t, felt):
    z = t.const(0)
    return t.ext_from([felt, z, z, z])


def _assert_ext_eq(t, a, b):
    from .dsl import Felt

    for i in range(4):
        t.assert_eq(Felt(t, a.r + i), Felt(t, b.r + i))


def traced_fri_verify_single(t: Tracer, pcs, proof, commit8, zeta4, ys,
                             log_n, width):
    """Traced verification of a TwoAdicFriPcs proof for ONE committed matrix
    opened at one point (the lift's FRI core: transcript replay, reduced
    opening at each queried index, fold chain, final-poly check, Merkle
    openings — mirrors stark/pcs.py verify for this shape).

    `t` must be a CONCRETE tracer (input_values set): the proof body enters
    as inline hints whose values come from `proof`, and the emitted program
    re-verifies it under the recursion machine's constraints."""
    from ..core import field as F
    from .dsl import Felt, TracedChallenger

    log_blowup = pcs.fri.log_blowup
    l = log_n + log_blowup
    ch = TracedChallenger(t)
    for f in commit8:
        ch.observe(f)
    alpha = _ext(t, ch.sample_ext())
    cp_commits = []
    betas = []
    for c in proof.commit_phase_commits:
        c8 = [t.hint(int(v)) for v in c]
        for f in c8:
            ch.observe(f)
        cp_commits.append(c8)
        betas.append(_ext(t, ch.sample_ext()))
    assert len(cp_commits) == l - log_blowup
    final_poly = [t.hint(int(v)) for v in proof.final_poly]
    for f in final_poly:
        ch.observe(f)
    if pcs.fri.proof_of_work_bits:
        pw = t.hint(int(proof.pow_witness))
        ch.observe(pw)
        pow_low = ch.sample_bits(pcs.fri.proof_of_work_bits)
        t.assert_eq(pow_low, t.const(0))
    half = (F.P_INT + 1) // 2
    for qp in proof.query_proofs:
        bits = ch.sample_bits_list(l)
        rows, path = qp.input_openings[0]
        row = [t.hint(int(v)) for v in rows[0]]
        path_h = [[t.hint(int(x)) for x in lvl] for lvl in path]
        traced_merkle_verify(t, row, bits, path_h, commit8)
        # reduced opening at x = GENERATOR * g_l^rev(index)
        g = F.two_adic_generator(l)
        x = t.const(F.GENERATOR % F.P_INT) * traced_pow_by_bits(
            t, g, bits, reverse=True)
        inv_zx = (_ext(t, zeta4) - x).inv()
        acc = None
        apow = None
        for c in range(width):
            ys_c = _ext(t, ys[4 * c : 4 * c + 4])
            if apow is None:
                acc = ys_c - row[c]
                apow = alpha
            else:
                acc, apow = t.fri_fold_step(acc, apow, alpha, ys_c, row[c])
        folded = acc * inv_zx
        cur_bits = bits
        shift = F.GENERATOR % F.P_INT
        cur_l = l
        for (pair_np, ppath), beta, c8 in zip(
            qp.commit_phase_openings, betas, cp_commits
        ):
            pair = [t.hint(int(v)) for v in pair_np.reshape(-1)]
            ppath_h = [[t.hint(int(x)) for x in lvl] for lvl in ppath]
            traced_merkle_verify(t, pair, cur_bits[1:], ppath_h, c8)
            b0 = cur_bits[0]
            sel = [t.select(b0, pair[4 + i], pair[i]) for i in range(4)]
            _assert_ext_eq(t, _ext(t, sel), folded)
            e0 = _ext(t, pair[:4])
            e1 = _ext(t, pair[4:])
            gl = F.two_adic_generator(cur_l)
            zero = t.const(0)
            xk = t.const(shift) * traced_pow_by_bits(
                t, gl, [zero] + cur_bits[1:], reverse=True)
            xk_inv = xk.inv()
            even = (e0 + e1) * t.const(half)
            odd = (e0 - e1) * t.const(half) * xk_inv
            folded = even + odd * beta
            cur_bits = cur_bits[1:]
            shift = (shift * shift) % F.P_INT
            cur_l -= 1
        _assert_ext_eq(t, folded, _ext(t, final_poly))


class TFV:
    """Traced folder value: a DSL Ext handle with FV operator surface, so
    chip `eval` runs unchanged as a 6th (traced) pass."""

    __slots__ = ("fl", "e")

    def __init__(self, fl, e):
        self.fl = fl
        self.e = e

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
        return self.fl._neg(self)


class TracedVerifierFolder:
    """VerifierFolder over DSL Ext handles: evaluates a chip's constraints
    at zeta INSIDE a recursion program (mirrors stark/folder.py
    VerifierFolder; acc folding acc = acc * alpha + e)."""

    def __init__(self, t: Tracer, prep_local, prep_next, main_local,
                 main_next, sels, public_values, alpha, perm_challenges,
                 local_cumulative_sum, perm_local=None, perm_next=None,
                 global_cumulative_sum=None):
        from ..stark.folder import _Builder

        _Builder.__init__(self)
        self.t = t
        self.sends = []
        self.receives = []
        self._cond = None
        mk = lambda es: [TFV(self, e) for e in es]
        self.prep_local = mk(prep_local)
        self.prep_next = mk(prep_next)
        self.main_local = mk(main_local)
        self.main_next = mk(main_next)
        self.public_values = [self._from_felt(f) for f in public_values]
        self.is_first_row = TFV(self, sels["is_first_row"])
        self.is_last_row = TFV(self, sels["is_last_row"])
        self.is_transition = TFV(self, sels["is_transition"])
        self.alpha = TFV(self, alpha)
        self.acc = self.lift(0)
        self.perm_challenges = tuple(TFV(self, c) for c in perm_challenges)
        self.local_cumulative_sum = TFV(self, local_cumulative_sum)
        self._perm_local = mk(perm_local) if perm_local is not None else None
        self._perm_next = mk(perm_next) if perm_next is not None else None
        if global_cumulative_sum is None:
            self.global_cumulative_sum = [self.lift(0)] * 14
        else:
            self.global_cumulative_sum = [
                self._from_felt(f) for f in global_cumulative_sum
            ]

    # builder surface (duplicated from _Builder to avoid MRO surprises)
    def when(self, cond):
        from ..stark.folder import _CondBuilder

        return _CondBuilder(self, cond)

    def when_first_row(self):
        return self.when(self.is_first_row)

    def when_last_row(self):
        return self.when(self.is_last_row)

    def when_transition(self):
        return self.when(self.is_transition)

    def assert_zero(self, e):
        self._fold(self.lift(e))

    def assert_eq(self, a, b):
        self.assert_zero(self.lift(a) - b)

    def assert_bool(self, e):
        e = self.lift(e)
        self.assert_zero(e * (e - 1))

    def assert_one(self, e):
        self.assert_zero(self.lift(e) - 1)

    def assert_zero_ext(self, e):
        self._fold(self.lift(e))

    def assert_eq_ext(self, a, b):
        self.assert_zero_ext(self.lift(a) - b)

    def send(self, kind, values, mult):
        from ..stark.lookup import Lookup, LookupScope

        self.sends.append(Lookup(kind, values, mult, LookupScope.Local))

    def receive(self, kind, values, mult):
        from ..stark.lookup import Lookup, LookupScope

        self.receives.append(Lookup(kind, values, mult, LookupScope.Local))

    def _from_felt(self, f):
        """Base felts stay LAZY (TFV.e may be a Felt): ext ops take base
        operands directly (EADDB/ESUBB/EMULB rows), so no 4-register
        packing happens until a genuinely base-valued result is needed
        as an ext window (folder.acc is always ext after one fold)."""
        if isinstance(f, TFV):
            return f
        if isinstance(f, Felt):
            return TFV(self, f)
        return self.lift(int(f))

    def lift(self, x):
        if isinstance(x, TFV):
            return x
        return TFV(self, self.t.const(int(x) % 2130706433))

    def _add(self, a, b):
        ae, be = a.e, b.e
        if isinstance(ae, Felt) and not isinstance(be, Felt):
            ae, be = be, ae  # commutative: keep the ext on the left
        return TFV(self, ae + be)

    def _sub(self, a, b):
        ae, be = a.e, b.e
        if isinstance(ae, Felt) and not isinstance(be, Felt):
            z = self.t.const(0)
            ae = self.t.ext_from([ae, z, z, z])
        return TFV(self, ae - be)

    def _mul(self, a, b):
        ae, be = a.e, b.e
        if isinstance(ae, Felt) and not isinstance(be, Felt):
            ae, be = be, ae
        return TFV(self, ae * be)

    def _neg(self, a):
        return self.lift(0) - a

    def perm_columns(self, width):
        assert len(self._perm_local) == width
        return self._perm_local, self._perm_next

    def _fold(self, e):
        self.acc = self.acc * self.alpha + e


def traced_merkle_verify_batch(t: Tracer, matrix_dims, index_bits,
                               rows, path, root8):
    """Multi-matrix MMCS opening (compress-and-inject, mirrors
    core/merkle.py verify_opening). `matrix_dims` is the static batch shape
    [(height, width)...]; `rows` are per-matrix felt lists; `index_bits` are
    the max-height index bits LSB-first; `path` has log(max_h) sibling
    digests."""
    heights = sorted({h for h, _ in matrix_dims}, reverse=True)
    max_h = heights[0]
    log_max = max_h.bit_length() - 1
    assert len(path) == log_max and len(index_bits) == log_max

    def rows_at(h):
        out = []
        for (hh, _w), r in zip(matrix_dims, rows):
            if hh == h:
                out.extend(r)
        return out

    digest = traced_hash_rows(t, rows_at(max_h))
    h = max_h
    for lvl in range(log_max):
        bit = index_bits[lvl]
        sibling = path[lvl]
        left = t.select8(bit, sibling, digest)
        right = t.select8(bit, digest, sibling)
        digest = traced_compress(t, left, right)
        h //= 2
        if any(hh == h for hh, _ in matrix_dims):
            inj = traced_hash_rows(t, rows_at(h))
            digest = traced_compress(t, digest, inj)
    for d, r in zip(digest, root8):
        t.assert_eq(d, r)


def ext_pow_const(t: Tracer, e, n: int):
    """e^n for Ext handle e and constant n, by square-and-multiply."""
    result = None
    base = e
    while n > 0:
        if n & 1:
            result = base if result is None else result * base
        base = base * base
        n >>= 1
    return result if result is not None else t.ext_const([1, 0, 0, 0])


def _monomial_combine(t: Tracer, flat4):
    """4 ext handles (base-column openings of one ext column) -> the ext
    value sum_e flat4[e] * X^e (mirrors stark/verifier.py _unflatten)."""
    acc = None
    for e in range(4):
        mono = [0, 0, 0, 0]
        mono[e] = 1
        term = flat4[e] * t.ext_const(mono)
        acc = term if acc is None else acc + term
    return acc


def traced_pcs_verify(t: Tracer, pcs, ch, rounds, proof):
    """Traced TwoAdicFriPcs.verify (multi-round, multi-matrix — mirrors
    stark/pcs.py verify + _verify_queries). `rounds` entries are
    (commit8_handles, [(log_n, width, [(z_ext, ys_ext_list)])]); the proof
    body enters as inline hints."""
    from ..core import field as F
    from .dsl import Felt

    log_blowup = pcs.fri.log_blowup
    alpha = t.ext_from(ch.sample_ext())
    cp_commits = []
    betas = []
    for c in proof.commit_phase_commits:
        c8 = [t.hint(int(v)) for v in c]
        for f in c8:
            ch.observe(f)
        cp_commits.append(c8)
        betas.append(t.ext_from(ch.sample_ext()))
    final_poly = [t.hint(int(v)) for v in proof.final_poly]
    for f in final_poly:
        ch.observe(f)
    if pcs.fri.proof_of_work_bits:
        pw = t.hint(int(proof.pow_witness))
        ch.observe(pw)
        t.assert_eq(ch.sample_bits(pcs.fri.proof_of_work_bits), t.const(0))
    heights = set()
    for _c8, mats in rounds:
        for log_n, _w, _pts in mats:
            heights.add(log_n + log_blowup)
    log_max = max(heights)
    assert len(cp_commits) == log_max - log_blowup
    half = (F.P_INT + 1) // 2
    zero = t.const(0)
    for qp in proof.query_proofs:
        bits = ch.sample_bits_list(log_max)
        # per-round batched input openings + reduced-opening accumulation
        ro = {}
        cnt_pows = {}  # height -> running alpha power (Ext handle)
        rows_per_round = []
        for (c8, mats), (rows_np, path_np) in zip(rounds, qp.input_openings):
            dims = [(1 << (log_n + log_blowup), w) for log_n, w, _ in mats]
            tree_log = max(h for h, _ in dims).bit_length() - 1
            rows_h = [[t.hint(int(v)) for v in r] for r in rows_np]
            path_h = [[t.hint(int(x)) for x in lvl] for lvl in path_np]
            traced_merkle_verify_batch(
                t, dims, bits[log_max - tree_log :], rows_h, path_h, c8
            )
            rows_per_round.append(rows_h)
        for (c8, mats), rows_h in zip(rounds, rows_per_round):
            for (log_n, w, pts), row in zip(mats, rows_h):
                if w == 0:
                    continue
                l = log_n + log_blowup
                if l not in ro:
                    ro[l] = None
                    cnt_pows[l] = None
                bits_l = bits[log_max - l :]
                g = F.two_adic_generator(l)
                x = t.const(F.GENERATOR % F.P_INT) * traced_pow_by_bits(
                    t, g, bits_l, reverse=True
                )
                for z, ys in pts:
                    inv_zx = (z - x).inv()
                    acc = None
                    for c in range(w):
                        ap = cnt_pows[l]
                        if ap is None:
                            acc = ys[c] - row[c]
                            cnt_pows[l] = alpha
                        elif acc is None:
                            acc, cnt_pows[l] = t.fri_fold_step(
                                _ezero(t), ap, alpha, ys[c], row[c])
                        else:
                            acc, cnt_pows[l] = t.fri_fold_step(
                                acc, ap, alpha, ys[c], row[c])
                    contrib = acc * inv_zx
                    ro[l] = contrib if ro[l] is None else ro[l] + contrib
        # fold chain
        ls = sorted(ro.keys(), reverse=True)
        l = ls[0]
        folded = ro[l]
        cur_bits = bits
        shift = F.GENERATOR % F.P_INT
        for (pair_np, ppath_np), beta, c8 in zip(
            qp.commit_phase_openings, betas, cp_commits
        ):
            pair = [t.hint(int(v)) for v in np.asarray(pair_np).reshape(-1)]
            ppath = [[t.hint(int(x)) for x in lvl] for lvl in ppath_np]
            traced_merkle_verify(t, pair, cur_bits[1:], ppath, c8)
            b0 = cur_bits[0]
            sel = [t.select(b0, pair[4 + i], pair[i]) for i in range(4)]
            _assert_ext_eq(t, t.ext_from(sel), folded)
            e0 = t.ext_from(pair[:4])
            e1 = t.ext_from(pair[4:])
            gl = F.two_adic_generator(l)
            xk = t.const(shift) * traced_pow_by_bits(
                t, gl, [zero] + cur_bits[1:], reverse=True
            )
            even = (e0 + e1) * t.const(half)
            odd = (e0 - e1) * t.const(half) * xk.inv()
            folded = even + odd * beta
            cur_bits = cur_bits[1:]
            shift = (shift * shift) % F.P_INT
            l -= 1
            if l in ro:
                folded = folded + ro[l]
        assert l == log_blowup
        _assert_ext_eq(t, folded, t.ext_from(final_poly))


def traced_verify_shard(t: Tracer, machine, vk, proof, pv_handles,
                        vk_commit_handles, extra_obs_handles=()):
    """The complete traced shard verifier (mirrors stark/verifier.py
    verify_shard + VerifyingKey.observe_into): transcript replay, FRI
    opening verification via traced_pcs_verify, per-chip constraint
    evaluation at zeta through the TracedVerifierFolder, quotient
    reconstruction, and the cumulative-sum checks. Public values are the
    recursion program's inputs; the proof body enters as hints.

    This IS the lift's core: proving this program attests the shard proof."""
    from ..core import field as F
    from .dsl import Felt, TracedChallenger

    pcs = machine.config.pcs
    chips = [machine.chip_by_name[n] for n in proof.chip_names]
    ch = TracedChallenger(t)
    # vk observation (VerifyingKey.observe_into)
    for f in vk_commit_handles:
        ch.observe(f)
    for f in extra_obs_handles:
        ch.observe(f)
    total = 8 + len(extra_obs_handles)
    for _ in range((-total) % 8):
        ch.observe(t.const(0))
    # transcript
    for f in pv_handles:
        ch.observe(f)
    main_c = [t.hint(int(v)) for v in proof.commitment.main]
    for f in main_c:
        ch.observe(f)
    perm_challenges = (t.ext_from(ch.sample_ext()),
                       t.ext_from(ch.sample_ext()))
    perm_c = [t.hint(int(v)) for v in proof.commitment.permutation]
    for f in perm_c:
        ch.observe(f)
    cumsums = []
    gsums = []
    for chip, vals in zip(chips, proof.opened_values):
        cs = [t.hint(int(v)) for v in vals.local_cumulative_sum]
        gs = [t.hint(int(v)) for v in vals.global_cumulative_sum]
        for f in cs:
            ch.observe(f)
        for f in gs:
            ch.observe(f)
        if chip.commit_scope.name == "Local":
            for f in gs:
                t.assert_eq(f, t.const(0))
        cumsums.append(cs)
        gsums.append(gs)
    alpha = t.ext_from(ch.sample_ext())
    quot_c = [t.hint(int(v)) for v in proof.commitment.quotient]
    for f in quot_c:
        ch.observe(f)
    zeta = t.ext_from(ch.sample_ext())

    trace_domains = [
        pcs.natural_domain_for_degree(1 << v.log_degree)
        for v in proof.opened_values
    ]

    def hint_flat(vals):
        out = []
        for v in vals:
            felts = [t.hint(int(x)) for x in np.asarray(v, np.uint32)]
            out.append(t.ext_from(felts))
        return out

    # hint every opened value once; the same handles feed the FRI rounds AND
    # the constraint folder (that shared use is the binding)
    opened = []
    for chip, vals in zip(chips, proof.opened_values):
        entry = {
            "prep_l": hint_flat(vals.preprocessed.local),
            "prep_n": hint_flat(vals.preprocessed.next),
            "main_l": hint_flat(vals.main.local),
            "main_n": hint_flat(vals.main.next),
            "perm_l": hint_flat(vals.permutation.local),
            "perm_n": hint_flat(vals.permutation.next),
            "quot": [hint_flat(chunk) for chunk in vals.quotient],
        }
        opened.append(entry)

    zeta_next = {}
    for dom in trace_domains:
        if dom.log_n not in zeta_next:
            zeta_next[dom.log_n] = zeta * t.ext_const(
                [dom.generator % F.P_INT, 0, 0, 0]
            )

    chip_ordering = proof.chip_ordering
    prep_round = []
    for name, dom, dims, local_only in vk.chip_information:
        i = chip_ordering[name]
        e = opened[i]
        pts = [(zeta, e["prep_l"])]
        if not local_only:
            pts.append((zeta_next.setdefault(
                dom.log_n, zeta * t.ext_const([dom.generator % F.P_INT, 0, 0, 0])
            ), e["prep_n"]))
        prep_round.append((dom.log_n, len(e["prep_l"]), pts))
    main_round = []
    perm_round = []
    quotient_round = []
    qc_domains_per_chip = []
    for chip, dom, e, vals in zip(chips, trace_domains, opened,
                                  proof.opened_values):
        pts = [(zeta, e["main_l"])]
        if not chip.local_only:
            pts.append((zeta_next[dom.log_n], e["main_n"]))
        main_round.append((dom.log_n, chip.width, pts))
        perm_round.append((dom.log_n, chip.perm_width * 4,
                           [(zeta, e["perm_l"]),
                            (zeta_next[dom.log_n], e["perm_n"])]))
        qdom = dom.create_disjoint_domain(
            1 << (dom.log_n + chip.log_quotient_degree))
        qc_domains = qdom.split_domains(chip.quotient_degree)
        qc_domains_per_chip.append(qc_domains)
        for sub_dom, chunk in zip(qc_domains, e["quot"]):
            quotient_round.append((sub_dom.log_n, 4, [(zeta, chunk)]))

    # pcs rounds: widths here are per-COLUMN counts of base openings; the
    # traced pcs treats each ys entry as one base column's ext opening
    rounds = []
    if vk.chip_information:
        rounds.append((vk_commit_handles, prep_round))
    rounds += [
        (main_c, main_round),
        (perm_c, perm_round),
        (quot_c, quotient_round),
    ]
    traced_pcs_verify(t, pcs, ch, rounds, proof.opening_proof)

    # constraint checks at zeta
    chip_infos = {nm: (dom, lo) for nm, dom, _d, lo in vk.chip_information}
    for k, (chip, dom, qc_domains, e) in enumerate(
        zip(chips, trace_domains, qc_domains_per_chip, opened)
    ):
        shift_inv = pow(int(dom.shift), F.P_INT - 2, F.P_INT)
        unshifted = zeta * t.ext_const([shift_inv, 0, 0, 0])
        one = t.ext_const([1, 0, 0, 0])
        z_h = ext_pow_const(t, unshifted, dom.size) - one
        g_inv = pow(dom.generator, F.P_INT - 2, F.P_INT)
        first = z_h * (unshifted - one).inv()
        last = z_h * (unshifted - t.ext_const([g_inv, 0, 0, 0])).inv()
        trans = unshifted - t.ext_const([g_inv, 0, 0, 0])
        inv_zeroifier = z_h.inv()
        # quotient recombination
        total = None
        for i_c, (sub_dom, chunk) in enumerate(zip(qc_domains, e["quot"])):
            zp = None
            for j_c, other in enumerate(qc_domains):
                if j_c == i_c:
                    continue
                from ..core import ext as EE

                o_shift_inv = pow(int(other.shift), F.P_INT - 2, F.P_INT)
                num = ext_pow_const(
                    t, zeta * t.ext_const([o_shift_inv, 0, 0, 0]), other.size
                ) - one
                den = other.zp_at_point(sub_dom.first_point())
                den_inv = [int(x) for x in EE.einv(den)]
                term = num * t.ext_const(den_inv)
                zp = term if zp is None else zp * term
            part = _monomial_combine(t, chunk)
            term = part if zp is None else zp * part
            total = term if total is None else total + term
        quotient = total
        prep_n = e["prep_n"] if e["prep_n"] else [
            t.ext_const([0, 0, 0, 0])] * chip.preprocessed_width
        main_n = e["main_n"] if e["main_n"] else [
            t.ext_const([0, 0, 0, 0])] * chip.width
        folder = TracedVerifierFolder(
            t, e["prep_l"], prep_n, e["main_l"], main_n,
            {"is_first_row": first, "is_last_row": last,
             "is_transition": trans},
            pv_handles, alpha, perm_challenges,
            t.ext_from(cumsums[k]),
            perm_local=[_monomial_combine(t, e["perm_l"][4 * c : 4 * c + 4])
                        for c in range(chip.perm_width)],
            perm_next=[_monomial_combine(t, e["perm_n"][4 * c : 4 * c + 4])
                       for c in range(chip.perm_width)],
            global_cumulative_sum=gsums[k],
        )
        chip.eval_with_perm(folder)
        folded = folder.acc.e * inv_zeroifier
        _assert_ext_eq(t, folded, quotient)
    # local cumulative sums must vanish over the shard
    for i in range(4):
        s = t.const(0)
        for cs in cumsums:
            s = s + cs[i]
        t.assert_eq(s, t.const(0))

    # expose the hinted per-chip septic global sums (bound to the trace by
    # the chip constraints above) so lifts can accumulate the cross-shard
    # digest in-circuit (reference: machine/core.rs global_cumulative_sums)
    return {
        "gsums": [
            (chip.name, gs)
            for chip, gs in zip(chips, gsums)
            if chip.commit_scope.name == "Global"
        ]
    }
