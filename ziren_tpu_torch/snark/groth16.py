"""Groth16 over BN254: setup + prove over a sparse R1CS, gnark-compatible
byte outputs (reference: crates/recursion/gnark-ffi/src/groth16_bn254.rs —
the Go gnark prover replaced by an in-house implementation over
ziren_tpu/verifier/bn254_pairing.py's curve arithmetic).

R1CS: constraints (A_k · w) * (B_k · w) = (C_k · w) over the BN254 scalar
field, wire 0 fixed to 1, wires 1..n_pub public. The QAP uses a power-of-two
evaluation domain in Fr (2-adicity 28); h(X) is computed on a coset.

Proof output is gnark's WriteTo layout (ar || bs || krs uncompressed,
nbCommitments=0 + zero PoK), verifying keys gnark's MarshalTo layout —
both round-trip through ziren_tpu.verifier.Groth16Verifier and byte-level
match what crates/verifier/src/groth16/converter.rs parses.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..verifier import bn254_pairing as bp

R = bp.R
G1 = (1, 2)
G2 = (
    bp.FQ2((
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    )),
    bp.FQ2((
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    )),
)

# Fr two-adic structure: r - 1 = 2^28 * odd, multiplicative generator 5
TWO_ADICITY = 28
_ODD = (R - 1) >> TWO_ADICITY


def _root_of_unity(log_n: int) -> int:
    assert log_n <= TWO_ADICITY
    return pow(pow(5, _ODD, R), 1 << (TWO_ADICITY - log_n), R)


@dataclass
class R1CS:
    """Sparse constraints: each of a/b/c is a list (per constraint) of
    {wire_index: coeff} dicts. num_wires includes wire 0 (constant one)."""

    num_wires: int
    num_public: int  # wires 1..num_public are public inputs
    a: list
    b: list
    c: list

    def eval_row(self, row: dict, w: list) -> int:
        return sum(coeff * w[i] for i, coeff in row.items()) % R


@dataclass
class ProvingKey:
    vk_bytes: bytes
    # G1 / G2 elements of the CRS
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    a_tau: list  # [u_i(tau)]_1
    b_tau1: list  # [v_i(tau)]_1
    b_tau2: list  # [v_i(tau)]_2
    l_tau: list  # [(beta u_i + alpha v_i + w_i)/delta]_1 for private wires
    zt: list  # [tau^i t(tau)/delta]_1
    r1cs: R1CS


def _domain_size(r1cs: R1CS) -> int:
    m = max(1, len(r1cs.a))
    return 1 << max(1, (m - 1).bit_length())


def _ntt(vals: list, invert: bool = False) -> list:
    """Iterative radix-2 Cooley-Tukey over Fr, O(n log n); large domains
    route through native/bn254_ntt.cpp."""
    n = len(vals)
    assert n & (n - 1) == 0
    if n >= 1024:
        from . import bn254_curve_native as bcn

        if bcn.ntt_available():
            root = _root_of_unity(n.bit_length() - 1)
            if invert:
                return bcn.ntt([v % R for v in vals],
                               pow(root, R - 2, R), True, pow(n, R - 2, R))
            return bcn.ntt([v % R for v in vals], root, False, 1)
    a = [v % R for v in vals]
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w = _root_of_unity(length.bit_length() - 1)
        if invert:
            w = pow(w, R - 2, R)
        half = length >> 1
        ws = [1] * half
        for i in range(1, half):
            ws[i] = ws[i - 1] * w % R
        for start in range(0, n, length):
            for i in range(half):
                u = a[start + i]
                v = a[start + i + half] * ws[i] % R
                a[start + i] = (u + v) % R
                a[start + i + half] = (u - v) % R
        length <<= 1
    if invert:
        n_inv = pow(n, R - 2, R)
        a = [x * n_inv % R for x in a]
    return a


def _batch_inv(vals: list) -> list:
    """Montgomery batch inversion (zeros pass through as zero)."""
    pref = []
    acc = 1
    for v in vals:
        pref.append(acc)
        if v:
            acc = acc * v % R
    inv = pow(acc, R - 2, R)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        if vals[i]:
            out[i] = inv * pref[i] % R
            inv = inv * vals[i] % R
    return out


def _lagrange_at(tau: int, n: int) -> list:
    """L_k(tau) for the size-n NTT domain: w^k (tau^n - 1) / (n (tau - w^k))."""
    w = _root_of_unity(n.bit_length() - 1)
    zh = (pow(tau, n, R) - 1) % R
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * w % R
    denoms = [(n * (tau - wk)) % R for wk in pows]
    invs = _batch_inv(denoms)
    return [pows[k] * zh % R * invs[k] % R for k in range(n)]


def _qap_evals_at_tau(r1cs: R1CS, tau: int, n: int):
    """u_i(tau), v_i(tau), w_i(tau) straight from the sparse rows via the
    Lagrange basis — O(n + nnz), no per-wire interpolation."""
    lag = _lagrange_at(tau, n)
    u = [0] * r1cs.num_wires
    v = [0] * r1cs.num_wires
    w = [0] * r1cs.num_wires
    for k, row in enumerate(r1cs.a):
        lk = lag[k]
        for i, coeff in row.items():
            u[i] = (u[i] + coeff * lk) % R
    for k, row in enumerate(r1cs.b):
        lk = lag[k]
        for i, coeff in row.items():
            v[i] = (v[i] + coeff * lk) % R
    for k, row in enumerate(r1cs.c):
        lk = lag[k]
        for i, coeff in row.items():
            w[i] = (w[i] + coeff * lk) % R
    return u, v, w


def setup(r1cs: R1CS, seed: bytes = b"ziren-groth16-dev") -> ProvingKey:
    """Deterministic (seed-derived) trusted setup — dev/test grade: the
    toxic waste is derivable from the seed, exactly like the reference's
    dev-mode artifacts built from dummy proofs (prover/src/build.rs)."""

    def felt(tag: bytes) -> int:
        return int.from_bytes(hashlib.sha256(seed + tag).digest(), "little") % R

    alpha, beta, gamma, delta, tau = (
        felt(b"alpha"), felt(b"beta"), felt(b"gamma"), felt(b"delta"),
        felt(b"tau"),
    )
    n = _domain_size(r1cs)
    t_tau = (pow(tau, n, R) - 1) % R
    gamma_inv = pow(gamma, R - 2, R)
    delta_inv = pow(delta, R - 2, R)

    u, v, w = _qap_evals_at_tau(r1cs, tau, n)

    n_pub = r1cs.num_public
    k_pub = [
        (beta * u[i] + alpha * v[i] + w[i]) % R * gamma_inv % R
        for i in range(n_pub + 1)
    ]
    l_priv = [
        (beta * u[i] + alpha * v[i] + w[i]) % R * delta_inv % R
        for i in range(n_pub + 1, r1cs.num_wires)
    ]

    alpha1 = bp.g1_mul(G1, alpha)
    beta1 = bp.g1_mul(G1, beta)
    beta2 = bp.g2_mul(G2, beta)
    gamma2 = bp.g2_mul(G2, gamma)
    delta1 = bp.g1_mul(G1, delta)
    delta2 = bp.g2_mul(G2, delta)

    zt_scalars = []
    acc = t_tau * delta_inv % R
    for _ in range(n):
        zt_scalars.append(acc)
        acc = acc * tau % R

    vk_bytes = _marshal_vk(
        alpha1, beta2, gamma2, delta2, _g1_fixed_batch(k_pub),
    )
    return ProvingKey(
        vk_bytes=vk_bytes,
        alpha1=alpha1, beta1=beta1, beta2=beta2,
        delta1=delta1, delta2=delta2,
        a_tau=_g1_fixed_batch(u),
        b_tau1=_g1_fixed_batch(v),
        b_tau2=_g2_fixed_batch(v),
        l_tau=_g1_fixed_batch(l_priv),
        zt=_g1_fixed_batch(zt_scalars),
        r1cs=r1cs,
    )


def _g1_fixed_batch(scalars):
    """scalar*G1 for many scalars (native fixed-base when available)."""
    from . import bn254_curve_native as bcn

    if bcn.available():
        return bcn.g1_fixed(G1, [s % R for s in scalars])
    return [bp.g1_mul(G1, s) for s in scalars]


def _g2_fixed_batch(scalars):
    from . import bn254_curve_native as bcn

    if bcn.available():
        out = []
        for p in bcn.g2_fixed(
            ((int(G2[0].c[0]), int(G2[0].c[1])),
             (int(G2[1].c[0]), int(G2[1].c[1]))),
            [s % R for s in scalars],
        ):
            out.append(None if p is None
                       else (bp.FQ2(p[0]), bp.FQ2(p[1])))
        return out
    return [bp.g2_mul(G2, s) for s in scalars]


def prove(pk: ProvingKey, witness: list, rand_seed: bytes = b"r") -> bytes:
    """witness: full wire assignment [1, publics..., privates...]. Returns
    gnark-layout proof bytes (ar || bs || krs || nbCommitments=0 || PoK=0)."""
    r1cs = pk.r1cs
    assert len(witness) == r1cs.num_wires
    witness = [x % R for x in witness]
    assert witness[0] == 1
    for ra, rb, rc in zip(r1cs.a, r1cs.b, r1cs.c):
        assert (
            r1cs.eval_row(ra, witness) * r1cs.eval_row(rb, witness) % R
            == r1cs.eval_row(rc, witness)
        ), "witness does not satisfy the R1CS"

    # h(X) = (A(X) B(X) - C(X)) / (X^n - 1) via coset evaluation:
    # on g*H the zeroifier is the CONSTANT g^n - 1, so h is three INTTs,
    # three coset NTTs, a pointwise combine and one INTT back.
    n = _domain_size(r1cs)
    a_ev = [0] * n
    b_ev = [0] * n
    c_ev = [0] * n
    for k in range(len(r1cs.a)):
        a_ev[k] = r1cs.eval_row(r1cs.a[k], witness)
        b_ev[k] = r1cs.eval_row(r1cs.b[k], witness)
        c_ev[k] = r1cs.eval_row(r1cs.c[k], witness)
    g = 5  # Fr multiplicative generator (not a 2^k-th root of unity)
    zh_coset_inv = pow((pow(g, n, R) - 1) % R, R - 2, R)
    from .frvec import FrVec

    def coset_evals(evals):
        return (FrVec.from_ints(evals).ntt(invert=True)
                * FrVec.powers(g, n)).ntt()

    ac, bc, cc = coset_evals(a_ev), coset_evals(b_ev), coset_evals(c_ev)
    h_coset = (ac * bc - cc).scale(zh_coset_inv)
    h_vec = h_coset.ntt(invert=True) * FrVec.powers(pow(g, R - 2, R), n)
    assert h_vec.item(n - 1) == 0, \
        "h degree overflow: t(X) does not divide A·B−C"
    h_coeffs = h_vec.to_ints()

    def felt(tag: bytes) -> int:
        wb = b"".join(x.to_bytes(32, "little") for x in witness[:2])
        return int.from_bytes(
            hashlib.sha256(rand_seed + tag + wb).digest(), "little"
        ) % R

    r_rand, s_rand = felt(b"r"), felt(b"s")

    def msm(points, scalars):
        from . import bn254_curve_native as bcn

        pairs = [(p, s % R) for p, s in zip(points, scalars)
                 if s % R != 0 and p is not None]
        if not pairs:
            return None
        if bcn.available():
            return bcn.g1_msm([p for p, _ in pairs], [s for _, s in pairs])
        acc = None
        for p, s in pairs:
            acc = bp._add(acc, bp.g1_mul(p, s))
        return acc

    ar = bp._add(
        bp._add(pk.alpha1, msm(pk.a_tau, witness)),
        bp.g1_mul(pk.delta1, r_rand),
    )
    bs1 = bp._add(
        bp._add(pk.beta1, msm(pk.b_tau1, witness)),
        bp.g1_mul(pk.delta1, s_rand),
    )
    bs = bp._add(
        bp._add(pk.beta2, _msm2(pk.b_tau2, witness)),
        bp.g2_mul(pk.delta2, s_rand),
    )
    n_pub = r1cs.num_public
    krs = msm(pk.l_tau, witness[n_pub + 1 :])
    krs = bp._add(krs, msm(pk.zt, h_coeffs))
    krs = bp._add(krs, bp.g1_mul(ar, s_rand))
    krs = bp._add(krs, bp.g1_mul(bs1, r_rand))
    krs = bp._add(krs, bp.g1_neg(bp.g1_mul(pk.delta1, r_rand * s_rand % R)))

    return (
        _g1_bytes(ar) + _g2_bytes(bs) + _g1_bytes(krs)
        + (0).to_bytes(4, "big") + bytes(64)
    )


def _msm2(points, scalars):
    from . import bn254_curve_native as bcn

    pairs = [(p, s % R) for p, s in zip(points, scalars)
             if s % R != 0 and p is not None]
    if not pairs:
        return None
    if bcn.available():
        got = bcn.g2_msm(
            [((int(p[0].c[0]), int(p[0].c[1])),
              (int(p[1].c[0]), int(p[1].c[1]))) for p, _ in pairs],
            [s for _, s in pairs],
        )
        return None if got is None else (bp.FQ2(got[0]), bp.FQ2(got[1]))
    acc = None
    for p, s in pairs:
        acc = bp._add(acc, bp.g2_mul(p, s))
    return acc


# ---------------------------------------------------------------------------
# gnark byte layouts (crates/verifier/src/groth16/converter.rs)
# ---------------------------------------------------------------------------


def _g1_bytes(pt) -> bytes:
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def _g2_bytes(pt) -> bytes:
    x, y = pt
    return (
        x.c[1].to_bytes(32, "big") + x.c[0].to_bytes(32, "big")
        + y.c[1].to_bytes(32, "big") + y.c[0].to_bytes(32, "big")
    )


def _g1_compress(pt) -> bytes:
    if pt is None:  # infinity: flag 01, zero payload
        b = bytearray(32)
        b[0] = 0b01 << 6
        return bytes(b)
    x, y = pt
    ys = bp.g1_y_from_x(x)
    flag = 0b10 if y == ys[0] else 0b11
    b = bytearray(x.to_bytes(32, "big"))
    b[0] |= flag << 6
    return bytes(b)


def _g2_compress(pt) -> bytes:
    if pt is None:
        b = bytearray(64)
        b[0] = 0b01 << 6
        return bytes(b)
    x, y = pt
    ys = bp.g2_y_from_x(x)
    flag = 0b10 if y == ys[0] else 0b11
    b = bytearray(x.c[1].to_bytes(32, "big"))
    b[0] |= flag << 6
    return bytes(b) + x.c[0].to_bytes(32, "big")


def _marshal_vk(alpha1, beta2, gamma2, delta2, k_points) -> bytes:
    """gnark MarshalTo layout as parsed by the reference converter:
    alpha(32) || pad(32) || beta(64) || gamma(64) || pad(32) || delta(64)
    || num_k(4) || k[i](32 each)."""
    out = bytearray()
    out += _g1_compress(alpha1)
    out += bytes(32)  # [beta]_1 slot, unused by the verifier
    out += _g2_compress(beta2)
    out += _g2_compress(gamma2)
    out += bytes(32)  # [delta]_1 slot, unused by the verifier
    out += _g2_compress(delta2)
    out += len(k_points).to_bytes(4, "big")
    for kp in k_points:
        out += _g1_compress(kp)
    return bytes(out)
