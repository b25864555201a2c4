"""Plonk over BN254 with KZG: constraint system, setup, prover — the
reference's gnark Plonk backend rebuilt in-house (reference:
crates/recursion/gnark-ffi/src/plonk_bn254.rs drives gnark's
backend/plonk; crates/verifier/src/plonk/* defines the exact protocol and
byte layouts this prover emits — see ziren_tpu/verifier/plonk.py, the
ported verifier these proofs check against).

Protocol recap (vanilla Plonk, 3 wires):
  gate i:  qL·l + qR·r + qM·l·r + qO·o + qK + PI(X) = 0   on H = <w>, |H|=n
  copy:    sigma over 3n slot positions, ids (w^i, u·w^i, u²·w^i), u = 5
  quotient: N / (X^n - 1) split into three (n+2)-coefficient chunks
  openings: KZG batch at zeta (linearization, l, r, o, s1, s2) + z at w·zeta
  transcript: gnark sha256 named challenges gamma/beta/alpha/zeta/u

The constraint system is converted from the same sparse R1CS the Groth16
path uses (snark/circuit.py CircuitBuilder), so `wrap_circuit` feeds both
SNARK backends: each R1CS row (A·w)(B·w)=(C·w) materializes its linear
combinations into chains of addition gates, then one multiplication gate.

No blinding is applied (dev-grade, like the seed-derived Groth16 setup:
proofs are sound but not zero-knowledge); gnark's BSB22 commitments are
not emitted."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..verifier import bn254_pairing as bp
from ..verifier.plonk import (
    GAMMA, BETA, ALPHA, ZETA, U,
    Transcript, fr_bytes, g1_bytes,
)
from .groth16 import (
    G1, G2, R,
    _g1_compress, _g2_compress, _g1_fixed_batch,
    _batch_inv, _ntt, _root_of_unity,
)

COSET_SHIFT = 5  # gnark's BN254 coset shift u (also the Fr generator)


# ---------------------------------------------------------------------------
# constraint system
# ---------------------------------------------------------------------------


@dataclass
class PlonkCS:
    """Gates + wiring. Variables are integer ids with values in `values`;
    each gate has three slots (l, r, o) holding variable ids."""

    nb_public: int = 0
    values: list = field(default_factory=list)  # variable id -> value
    ql: list = field(default_factory=list)
    qr: list = field(default_factory=list)
    qm: list = field(default_factory=list)
    qo: list = field(default_factory=list)
    qk: list = field(default_factory=list)
    wl: list = field(default_factory=list)  # variable id per L slot
    wr: list = field(default_factory=list)
    wo: list = field(default_factory=list)

    def new_var(self, value: int) -> int:
        self.values.append(int(value) % R)
        return len(self.values) - 1

    def _dummy(self) -> int:
        return self.new_var(0)

    def gate(self, ql=0, qr=0, qm=0, qo=0, qk=0, l=None, r=None, o=None):
        self.ql.append(ql % R)
        self.qr.append(qr % R)
        self.qm.append(qm % R)
        self.qo.append(qo % R)
        self.qk.append(qk % R)
        self.wl.append(l if l is not None else self._dummy())
        self.wr.append(r if r is not None else self._dummy())
        self.wo.append(o if o is not None else self._dummy())

    @property
    def num_gates(self) -> int:
        return len(self.ql)

    def check(self, public_inputs) -> bool:
        v = self.values
        for i in range(self.num_gates):
            pi = public_inputs[i] if i < len(public_inputs) else 0
            got = (
                self.ql[i] * v[self.wl[i]] + self.qr[i] * v[self.wr[i]]
                + self.qm[i] * v[self.wl[i]] * v[self.wr[i]]
                + self.qo[i] * v[self.wo[i]] + self.qk[i] + pi
            ) % R
            if got:
                return False
        return True


def from_r1cs(r1cs, witness) -> tuple:
    """Convert a satisfied sparse R1CS (snark/groth16.py layout: wire 0 is
    the constant one, wires 1..num_public public) into a PlonkCS.
    Returns (cs, public_inputs)."""
    cs = PlonkCS()
    cs.nb_public = r1cs.num_public
    witness = [int(x) % R for x in witness]
    # variable ids 0..num_wires-1 mirror the R1CS wires
    cs.values = list(witness)
    publics = witness[1 : r1cs.num_public + 1]
    # public-input gates first (gnark layout): qL = -1, PI(X) adds w_i
    for i in range(r1cs.num_public):
        cs.gate(ql=R - 1, l=1 + i)

    def materialize(row: dict):
        """Linear combination -> (variable id | None, constant). The id's
        value equals the whole LC (constant folded in) when present."""
        k0 = row.get(0, 0) % R
        ts = [(i, c % R) for i, c in row.items() if i != 0 and c % R]
        if not ts:
            return None, k0
        if len(ts) == 1 and ts[0][1] == 1 and k0 == 0:
            return ts[0][0], 0
        # first gate folds two terms + the constant
        (i1, c1) = ts[0]
        acc_val = (c1 * cs.values[i1] + k0) % R
        if len(ts) > 1:
            i2, c2 = ts[1]
            acc_val = (acc_val + c2 * cs.values[i2]) % R
            acc = cs.new_var(acc_val)
            cs.gate(ql=c1, qr=c2, qk=k0, qo=R - 1, l=i1, r=i2, o=acc)
            rest = ts[2:]
        else:
            acc = cs.new_var(acc_val)
            cs.gate(ql=c1, qk=k0, qo=R - 1, l=i1, o=acc)
            rest = []
        for (ij, cj) in rest:
            acc_val = (acc_val + cj * cs.values[ij]) % R
            nxt = cs.new_var(acc_val)
            cs.gate(ql=1, qr=cj, qo=R - 1, l=acc, r=ij, o=nxt)
            acc = nxt
        return acc, 0

    for ra, rb, rc in zip(r1cs.a, r1cs.b, r1cs.c):
        va, ka = materialize(ra)
        vb, kb = materialize(rb)
        vc, kc = materialize(rc)
        if va is not None and vb is not None:
            if vc is not None:
                cs.gate(qm=1, qo=R - 1, l=va, r=vb, o=vc)
            else:
                cs.gate(qm=1, qk=(-kc) % R, l=va, r=vb)
        elif va is not None:  # B constant
            if vc is not None:
                cs.gate(ql=kb, qo=R - 1, l=va, o=vc)
            else:
                cs.gate(ql=kb, qk=(-kc) % R, l=va)
        elif vb is not None:  # A constant
            if vc is not None:
                cs.gate(qr=ka, qo=R - 1, r=vb, o=vc)
            else:
                cs.gate(qr=ka, qk=(-kc) % R, r=vb)
        else:  # both constant
            if vc is not None:
                cs.gate(qo=1, qk=(-(ka * kb)) % R, o=vc)
            else:
                assert (ka * kb - kc) % R == 0, "unsatisfiable constant row"
    assert cs.check(publics), "Plonk conversion does not satisfy the gates"
    return cs, publics


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------


@dataclass
class PlonkProvingKey:
    vk_bytes: bytes
    n: int
    omega: int
    srs_g1: list  # [tau^i]G1, len n+3
    # selector / permutation polynomial coefficients + commitments
    q_coeffs: dict  # name -> coeffs (len n)
    s_coeffs: list  # 3 x coeffs
    s_evals: list  # 3 x evals over H (sigma id values)
    perm_cols: list  # wl/wr/wo variable ids padded to n
    cs: PlonkCS
    publics_len: int


def _domain(cs: PlonkCS) -> int:
    m = max(cs.num_gates, 2)
    return 1 << (m - 1).bit_length()


def _pad(vals: list, n: int) -> list:
    return list(vals) + [0] * (n - len(vals))


def _sigma_evals(cs: PlonkCS, n: int, omega: int):
    """Permutation polynomials' evaluations: position (col j, row i) has id
    u^j * w^i; sigma cycles the positions sharing a variable."""
    cols = [_pad_slots(cs.wl, cs, n), _pad_slots(cs.wr, cs, n),
            _pad_slots(cs.wo, cs, n)]
    pos_of_var: dict = {}
    for j in range(3):
        for i in range(n):
            pos_of_var.setdefault(cols[j][i], []).append((j, i))
    w_pows = [1] * n
    for i in range(1, n):
        w_pows[i] = w_pows[i - 1] * omega % R
    ids = [[pow(COSET_SHIFT, j, R) * w_pows[i] % R for i in range(n)]
           for j in range(3)]
    sig = [[0] * n for _ in range(3)]
    for positions in pos_of_var.values():
        m = len(positions)
        for k, (j, i) in enumerate(positions):
            nj, ni = positions[(k + 1) % m]
            sig[j][i] = ids[nj][ni]
    return sig, cols


def _pad_slots(slots: list, cs: PlonkCS, n: int) -> list:
    out = list(slots)
    while len(out) < n:
        out.append(cs.new_var(0))
    return out


def _commit(srs_g1: list, coeffs: list):
    from . import bn254_curve_native as bcn

    pairs = [(p, c % R) for p, c in zip(srs_g1, coeffs)
             if c % R and p is not None]
    if not pairs:
        return None
    if bcn.available():
        return bcn.g1_msm([p for p, _ in pairs], [c for _, c in pairs])
    acc = None
    for p, c in pairs:
        acc = bp._add(acc, bp.g1_mul(p, c))
    return acc


_LINES_PAD = 33788


def setup(cs: PlonkCS, seed: bytes = b"ziren-plonk-dev") -> PlonkProvingKey:
    """Deterministic (seed-derived) KZG setup — dev/test grade, like the
    Groth16 path's dummy artifacts (reference prover/src/build.rs)."""
    tau = int.from_bytes(hashlib.sha256(seed + b"tau").digest(), "little") % R
    n = _domain(cs)
    omega = _root_of_unity(n.bit_length() - 1)
    taus = [1] * (n + 3)
    for i in range(1, n + 3):
        taus[i] = taus[i - 1] * tau % R
    srs_g1 = _g1_fixed_batch(taus)
    g2_1 = bp.g2_mul(G2, tau)

    q_coeffs = {}
    for name, vals in (("ql", cs.ql), ("qr", cs.qr), ("qm", cs.qm),
                       ("qo", cs.qo), ("qk", cs.qk)):
        q_coeffs[name] = _ntt(_pad(vals, n), invert=True)
    s_evals, cols = _sigma_evals(cs, n, omega)
    s_coeffs = [_ntt(s, invert=True) for s in s_evals]

    cq = {k: _commit(srs_g1, c) for k, c in q_coeffs.items()}
    cs_ = [_commit(srs_g1, c) for c in s_coeffs]

    vk = bytearray()
    vk += n.to_bytes(8, "big")
    vk += pow(n, R - 2, R).to_bytes(32, "big")
    vk += omega.to_bytes(32, "big")
    vk += cs.nb_public.to_bytes(8, "big")
    vk += COSET_SHIFT.to_bytes(32, "big")
    for pt in (*cs_, cq["ql"], cq["qr"], cq["qm"], cq["qo"], cq["qk"]):
        vk += _g1_compress(pt)
    vk += (0).to_bytes(4, "big")  # num qcp
    vk += _g1_compress(G1)
    vk += _g2_compress(G2)
    vk += _g2_compress(g2_1)
    vk += bytes(_LINES_PAD)  # precomputed pairing lines: unused by verifier
    vk += (0).to_bytes(8, "big")  # commitment constraint indexes

    return PlonkProvingKey(
        vk_bytes=bytes(vk), n=n, omega=omega, srs_g1=srs_g1,
        q_coeffs=q_coeffs, s_coeffs=s_coeffs, s_evals=s_evals,
        perm_cols=cols, cs=cs, publics_len=cs.nb_public,
    )


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def prove(pk: PlonkProvingKey, public_inputs) -> bytes:
    """Produce gnark-layout Plonk proof bytes for the key's wired witness
    (PlonkCS carries the values; public_inputs must match its first wires).

    Every O(n)/O(4n) pointwise pass runs on FrVec (snark/frvec.py) — native
    threaded Fr kernels — so wrap-scale circuits (~2^23 gates) spend their
    time in NTTs and MSMs, not python loops."""
    from .frvec import FrVec

    cs, n, omega = pk.cs, pk.n, pk.omega
    publics = [int(v) % R for v in public_inputs]
    assert len(publics) == cs.nb_public
    assert cs.check(publics), "witness does not satisfy the gates"
    v = cs.values
    cols = pk.perm_cols
    l_ev = FrVec.from_ints([v[cols[0][i]] for i in range(n)])
    r_ev = FrVec.from_ints([v[cols[1][i]] for i in range(n)])
    o_ev = FrVec.from_ints([v[cols[2][i]] for i in range(n)])
    l_c = l_ev.ntt(invert=True)
    r_c = r_ev.ntt(invert=True)
    o_c = o_ev.ntt(invert=True)
    c_l, c_r, c_o = (_commit(pk.srs_g1, c.to_ints())
                     for c in (l_c, r_c, o_c))

    vkb = pk.vk_bytes
    # re-derive the vk commitments for transcript binding
    from ..verifier.plonk import load_vk

    vk = load_vk(vkb)
    fs = Transcript([GAMMA, BETA, ALPHA, ZETA, U])
    for pt in (*vk.s, vk.ql, vk.qr, vk.qm, vk.qo, vk.qk):
        fs.bind(GAMMA, g1_bytes(pt))
    for w in publics:
        fs.bind(GAMMA, fr_bytes(w))
    for pt in (c_l, c_r, c_o):
        fs.bind(GAMMA, g1_bytes(pt))
    gamma = fs.fr(GAMMA)
    beta = fs.fr(BETA)

    # grand product z
    w_pows = FrVec.powers(omega, n)
    u1, u2 = COSET_SHIFT, COSET_SHIFT * COSET_SHIFT % R
    s1e, s2e, s3e = (FrVec.from_ints(s) for s in pk.s_evals)
    numers = (
        (l_ev + w_pows.scale(beta)).add_scalar(gamma)
        * (r_ev + w_pows.scale(beta * u1 % R)).add_scalar(gamma)
        * (o_ev + w_pows.scale(beta * u2 % R)).add_scalar(gamma)
    )
    denoms = (
        (l_ev + s1e.scale(beta)).add_scalar(gamma)
        * (r_ev + s2e.scale(beta)).add_scalar(gamma)
        * (o_ev + s3e.scale(beta)).add_scalar(gamma)
    )
    z_ev = FrVec.prefix_mul(numers * FrVec.batch_inv(denoms))
    assert z_ev.item(0) == 1
    z_c = z_ev.ntt(invert=True)
    c_z = _commit(pk.srs_g1, z_c.to_ints())
    fs.bind(ALPHA, g1_bytes(c_z))
    alpha = fs.fr(ALPHA)

    # quotient on a 4n coset
    big = 4 * n
    g = COSET_SHIFT

    def ce(c):  # coeffs (FrVec, len <= big) -> evals over g * H_big
        return (c * FrVec.powers(g, len(c))).pad(big).ntt()

    L = ce(l_c)
    Rv = ce(r_c)
    O = ce(o_c)
    Z = ce(z_c)
    zw_c = z_c * w_pows  # z(wX): coeff k scaled by omega^k
    ZW = ce(zw_c)
    q_v = {k: FrVec.from_ints(pk.q_coeffs[k])
           for k in ("ql", "qr", "qm", "qo", "qk")}
    Ql, Qr, Qm, Qo, Qk = (ce(q_v[k]) for k in ("ql", "qr", "qm", "qo", "qk"))
    s_cv = [FrVec.from_ints(c) for c in pk.s_coeffs]
    S1, S2, S3 = (ce(c) for c in s_cv)
    PI = ce(FrVec.from_ints(_pad(publics, n)).ntt(invert=True))
    L1 = ce(FrVec.powers(1, n, start=pow(n, R - 2, R)))  # L1 coeffs: 1/n
    # X on the coset; Zh(X) = X^n - 1 (evals are a geometric sequence:
    # (g * wb^k)^n = g^n * (wb^n)^k)
    wb = _root_of_unity(big.bit_length() - 1)
    xs = FrVec.powers(wb, big, start=g)
    zh = FrVec.powers(pow(wb, n, R), big, start=pow(g, n, R)).add_scalar(R - 1)
    zh_inv = FrVec.batch_inv(zh)
    gate = Ql * L + Qr * Rv + Qm * L * Rv + Qo * O + Qk + PI
    t_id = (
        (L + xs.scale(beta)).add_scalar(gamma)
        * (Rv + xs.scale(beta * u1 % R)).add_scalar(gamma)
        * (O + xs.scale(beta * u2 % R)).add_scalar(gamma)
        * Z
    )
    t_sig = (
        (L + S1.scale(beta)).add_scalar(gamma)
        * (Rv + S2.scale(beta)).add_scalar(gamma)
        * (O + S3.scale(beta)).add_scalar(gamma)
        * ZW
    )
    perm = t_sig - t_id
    start_t = L1 * Z.add_scalar(R - 1)
    num = gate + perm.scale(alpha) + start_t.scale(alpha * alpha % R)
    h_c = (num * zh_inv).ntt(invert=True) * FrVec.powers(
        pow(g, R - 2, R), big)
    assert not h_c.a[3 * n + 6:].any(), "quotient degree overflow"
    chunk = n + 2
    h_parts = [h_c.slice(i * chunk, (i + 1) * chunk).pad(chunk)
               for i in range(3)]
    c_h = [_commit(pk.srs_g1, hp.to_ints()) for hp in h_parts]
    for pt in c_h:
        fs.bind(ZETA, g1_bytes(pt))
    zeta = fs.fr(ZETA)

    # openings
    l_z = l_c.horner(zeta)
    r_z = r_c.horner(zeta)
    o_z = o_c.horner(zeta)
    s1_z = s_cv[0].horner(zeta)
    s2_z = s_cv[1].horner(zeta)
    zeta_w = zeta * omega % R
    zu = z_c.horner(zeta_w)

    zh_zeta = (pow(zeta, n, R) - 1) % R
    lag1 = zh_zeta * pow((zeta - 1) % R, R - 2, R) % R * pow(n, R - 2, R) % R
    alpha2_l1 = lag1 * alpha % R * alpha % R
    # linearization polynomial (see verifier.plonk.verify_plonk_algebraic)
    _s1 = (beta * s1_z + l_z + gamma) % R
    _s1 = _s1 * ((beta * s2_z + r_z + gamma) % R) % R * beta % R * alpha % R * zu % R
    _s2 = (beta * zeta + gamma + l_z) % R
    _s2 = _s2 * ((beta * u1 % R * zeta + gamma + r_z) % R) % R
    _s2 = _s2 * ((beta * u2 % R * zeta + gamma + o_z) % R) % R
    _s2 = (-(_s2 * alpha)) % R
    coeff_z = (alpha2_l1 + _s2) % R
    zeta_n2 = pow(zeta, n + 2, R)
    lin = FrVec.zeros(max(n, chunk))
    lin.axpy_(l_z, q_v["ql"])
    lin.axpy_(r_z, q_v["qr"])
    lin.axpy_(l_z * r_z % R, q_v["qm"])
    lin.axpy_(o_z, q_v["qo"])
    lin.axpy_(1, q_v["qk"])
    lin.axpy_(_s1, s_cv[2])
    lin.axpy_(coeff_z, z_c)
    lin.axpy_((-zh_zeta) % R, h_parts[0])
    lin.axpy_((-(zeta_n2 * zh_zeta)) % R, h_parts[1])
    lin.axpy_((-(zeta_n2 * zeta_n2 % R * zh_zeta)) % R, h_parts[2])

    # PI at zeta (for the sanity check below only)
    pi_z = 0
    accw = 1
    ninv = pow(n, R - 2, R)
    for w in publics:
        li = zh_zeta * pow((zeta - accw) % R, R - 2, R) % R * ninv % R * accw % R
        pi_z = (pi_z + li * w) % R
        accw = accw * omega % R
    const_lin = (beta * s1_z + gamma + l_z) % R
    const_lin = const_lin * ((beta * s2_z + gamma + r_z) % R) % R
    const_lin = const_lin * ((o_z + gamma) % R) % R * alpha % R * zu % R
    const_lin = (-(const_lin - alpha2_l1 + pi_z)) % R
    assert lin.horner(zeta) == const_lin, "linearization mismatch"

    # batched KZG opening at zeta
    digests_c = [None, c_l, c_r, c_o, vk.s[0], vk.s[1]]
    digests_c[0] = _commit(pk.srs_g1, lin.to_ints())
    polys = [lin, l_c, r_c, o_c, s_cv[0], s_cv[1]]
    claimed = [const_lin, l_z, r_z, o_z, s1_z, s2_z]
    from ..verifier.plonk import _derive_gamma

    gamma_f = _derive_gamma(zeta, digests_c, claimed, fr_bytes(zu))
    fs.bind(U, fr_bytes(gamma_f))
    folded = FrVec.zeros(max(len(p) for p in polys))
    gpow = 1
    for p in polys:
        folded.axpy_(gpow, p)
        gpow = gpow * gamma_f % R
    hq = folded.div_linear(zeta)
    c_hq = _commit(pk.srs_g1, hq.to_ints())
    hz = z_c.div_linear(zeta_w)
    c_hz = _commit(pk.srs_g1, hz.to_ints())

    out = bytearray()
    for pt in (c_l, c_r, c_o, *c_h):
        out += g1_bytes(pt)
    for val in (l_z, r_z, o_z, s1_z, s2_z):
        out += fr_bytes(val)
    out += g1_bytes(c_z)
    out += fr_bytes(zu)
    out += g1_bytes(c_hq)
    out += g1_bytes(c_hz)
    return bytes(out)
