"""Portable gnark-Plonk verifier over BN254 (reference:
crates/verifier/src/plonk/{verify.rs, kzg.rs, transcript.rs, converter.rs}).

Protocol: vanilla Plonk (3 wires, qL/qR/qM/qO/qK selectors, copy
permutation with coset shifts 1/u/u², KZG multi-point batch opening at
zeta and omega*zeta), gnark's sha256 named-challenge Fiat-Shamir
(gamma -> beta -> alpha -> zeta -> u), byte layouts exactly as parsed by
the reference converter (this module is the in-env stand-in for the
missing Rust toolchain: snark/plonk.py proves, this verifies).

BSB22 custom-gate commitments are not supported (the in-house prover
never emits them; the reference wrap circuit uses none either)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import bn254_pairing as bp
from .groth16 import compressed_x_to_g1, compressed_x_to_g2, uncompressed_g1

R = bp.R

GAMMA, BETA, ALPHA, ZETA, U = "gamma", "beta", "alpha", "zeta", "u"


class PlonkError(Exception):
    pass


class Transcript:
    """gnark fiat-shamir: sha256(challenge_name || prev_challenge ||
    bindings...), challenges computed in declaration order
    (reference transcript.rs)."""

    def __init__(self, names):
        self.order = list(names)
        self.bindings = {n: [] for n in names}
        self.values = {}

    def bind(self, name: str, data: bytes):
        if name in self.values:
            raise PlonkError(f"challenge {name} already computed")
        self.bindings[name].append(bytes(data))

    def challenge(self, name: str) -> bytes:
        if name in self.values:
            return self.values[name]
        pos = self.order.index(name)
        h = hashlib.sha256()
        h.update(name.encode())
        if pos > 0:
            prev = self.order[pos - 1]
            if prev not in self.values:
                raise PlonkError("previous challenge not computed")
            h.update(self.values[prev])
        for b in self.bindings[name]:
            h.update(b)
        out = h.digest()
        self.values[name] = out
        return out

    def fr(self, name: str) -> int:
        return int.from_bytes(self.challenge(name), "big") % R


def g1_bytes(pt) -> bytes:
    """x || y, 32-byte big-endian each; infinity = 64 zero bytes
    (reference converter.rs g1_to_bytes)."""
    if pt is None:
        return bytes(64)
    return int(pt[0]).to_bytes(32, "big") + int(pt[1]).to_bytes(32, "big")


def fr_bytes(v: int) -> bytes:
    return (int(v) % R).to_bytes(32, "big")


@dataclass
class PlonkVerifyingKey:
    size: int
    size_inv: int
    generator: int
    nb_public: int
    coset_shift: int
    s: list  # [s1, s2, s3] G1
    ql: tuple
    qr: tuple
    qm: tuple
    qo: tuple
    qk: tuple
    kzg_g1: tuple
    kzg_g2: list  # [G2, tau*G2]


@dataclass
class PlonkProof:
    lro: list  # 3 G1
    z: tuple
    h: list  # 3 G1
    claimed_values: list  # l, r, o, s1, s2 at zeta
    z_shifted_value: int
    batched_h: tuple
    z_shifted_h: tuple


# -- byte layouts (reference plonk/converter.rs) -----------------------------

_LINES_PAD = 33788  # precomputed pairing lines blob, unused by this verifier


def load_vk(buf: bytes) -> PlonkVerifyingKey:
    size = int.from_bytes(buf[0:8], "big")
    size_inv = int.from_bytes(buf[8:40], "big")
    generator = int.from_bytes(buf[40:72], "big")
    nb_public = int.from_bytes(buf[72:80], "big")
    coset_shift = int.from_bytes(buf[80:112], "big")
    pts = [compressed_x_to_g1(buf[112 + 32 * i : 144 + 32 * i]) for i in range(8)]
    s = pts[:3]
    ql, qr, qm, qo, qk = pts[3:]
    num_qcp = int.from_bytes(buf[368:372], "big")
    if num_qcp:
        raise PlonkError("qcp/BSB22 commitments unsupported")
    off = 372
    g1 = compressed_x_to_g1(buf[off : off + 32])
    g2_0 = compressed_x_to_g2(buf[off + 32 : off + 96])
    g2_1 = compressed_x_to_g2(buf[off + 96 : off + 160])
    off += 160 + _LINES_PAD
    n_cci = int.from_bytes(buf[off : off + 8], "big")
    if n_cci:
        raise PlonkError("commitment constraint indexes unsupported")
    return PlonkVerifyingKey(
        size=size, size_inv=size_inv, generator=generator,
        nb_public=nb_public, coset_shift=coset_shift, s=s,
        ql=ql, qr=qr, qm=qm, qo=qo, qk=qk, kzg_g1=g1, kzg_g2=[g2_0, g2_1],
    )


def load_proof(buf: bytes) -> PlonkProof:
    lro = [uncompressed_g1(buf[64 * i : 64 * i + 64]) for i in range(3)]
    h = [uncompressed_g1(buf[192 + 64 * i : 256 + 64 * i]) for i in range(3)]
    off = 384
    claimed = []
    for _ in range(5):
        claimed.append(int.from_bytes(buf[off : off + 32], "big") % R)
        off += 32
    z = uncompressed_g1(buf[off : off + 64])
    zu = int.from_bytes(buf[off + 64 : off + 96], "big") % R
    off += 96
    batched_h = uncompressed_g1(buf[off : off + 64])
    z_shift_h = uncompressed_g1(buf[off + 64 : off + 128])
    return PlonkProof(
        lro=lro, z=z, h=h, claimed_values=claimed,
        z_shifted_value=zu, batched_h=batched_h, z_shifted_h=z_shift_h,
    )


# -- KZG (reference plonk/kzg.rs) --------------------------------------------


def _msm(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        s = s % R
        if s == 0 or p is None:
            continue
        acc = bp._add(acc, bp.g1_mul(p, s))
    return acc


def _derive_gamma(point, digests, claimed_values, data_transcript) -> int:
    t = Transcript([GAMMA])
    t.bind(GAMMA, fr_bytes(point))
    for d in digests:
        t.bind(GAMMA, g1_bytes(d))
    for v in claimed_values:
        t.bind(GAMMA, fr_bytes(v))
    if data_transcript is not None:
        t.bind(GAMMA, data_transcript)
    return t.fr(GAMMA)


def fold_proof(digests, batched_h, claimed_values, point, data_transcript,
               transcript: Transcript):
    """Fold the batched opening (claimed_values[i] for digests[i]) into one
    (digest, value, h) opening at `point`; binds gamma into the global
    transcript for the U challenge."""
    gamma = _derive_gamma(point, digests, claimed_values, data_transcript)
    transcript.bind(U, fr_bytes(gamma))
    gammai = [1]
    for _ in range(1, len(digests)):
        gammai.append(gammai[-1] * gamma % R)
    folded_eval = sum(v * c for v, c in zip(claimed_values, gammai)) % R
    folded_digest = _msm(digests, gammai)
    return (batched_h, folded_eval), folded_digest


def batch_verify_multi_points(digests, proofs, points, u, vk) -> None:
    """proofs: [(h, claimed_value)]. One 2-pairing check for all openings."""
    rand = [1]
    for _ in range(1, len(digests)):
        rand.append(rand[-1] * u % R)
    quotients = [h for h, _v in proofs]
    folded_quotients = _msm(quotients, rand)
    evals = [v for _h, v in proofs]
    folded_digests = _msm(digests, rand)
    folded_evals = sum(v * c for v, c in zip(evals, rand)) % R
    folded_digests = bp._add(
        folded_digests, bp.g1_neg(bp.g1_mul(vk.kzg_g1, folded_evals))
    )
    folded_points_quotients = _msm(
        quotients, [r * p % R for r, p in zip(rand, points)]
    )
    folded_digests = bp._add(folded_digests, folded_points_quotients)
    ok = bp.pairing_batch([
        (folded_digests, vk.kzg_g2[0]),
        (bp.g1_neg(folded_quotients), vk.kzg_g2[1]),
    ])
    if not ok:
        raise PlonkError("KZG pairing check failed")


# -- the verifier (reference plonk/verify.rs) --------------------------------


def verify_plonk_algebraic(vk: PlonkVerifyingKey, proof: PlonkProof,
                           public_inputs) -> None:
    public_inputs = [int(v) % R for v in public_inputs]
    if len(public_inputs) != vk.nb_public:
        raise PlonkError("wrong number of public inputs")

    fs = Transcript([GAMMA, BETA, ALPHA, ZETA, U])
    # bind public data
    for pt in (*vk.s, vk.ql, vk.qr, vk.qm, vk.qo, vk.qk):
        fs.bind(GAMMA, g1_bytes(pt))
    for w in public_inputs:
        fs.bind(GAMMA, fr_bytes(w))
    for pt in proof.lro:
        fs.bind(GAMMA, g1_bytes(pt))
    gamma = fs.fr(GAMMA)
    beta = fs.fr(BETA)
    fs.bind(ALPHA, g1_bytes(proof.z))
    alpha = fs.fr(ALPHA)
    for pt in proof.h:
        fs.bind(ZETA, g1_bytes(pt))
    zeta = fs.fr(ZETA)

    n = vk.size
    zh_zeta = (pow(zeta, n, R) - 1) % R
    lagrange_one = (
        pow((zeta - 1) % R, R - 2, R) * zh_zeta % R * vk.size_inv % R
    )

    # PI = sum_i L_i(zeta) w_i
    pi = 0
    accw = 1
    for w in public_inputs:
        li = zh_zeta * pow((zeta - accw) % R, R - 2, R) % R
        li = li * vk.size_inv % R * accw % R
        pi = (pi + li * w) % R
        accw = accw * vk.generator % R

    l, r, o, s1, s2 = proof.claimed_values
    zu = proof.z_shifted_value

    alpha2_l1 = lagrange_one * alpha % R * alpha % R

    # const_lin = -(PI - alpha^2 L1 + alpha (l+b s1+g)(r+b s2+g)(o+g) zu)
    const_lin = (beta * s1 + gamma + l) % R
    const_lin = const_lin * ((beta * s2 + gamma + r) % R) % R
    const_lin = const_lin * ((o + gamma) % R) % R
    const_lin = const_lin * alpha % R * zu % R
    const_lin = (const_lin - alpha2_l1 + pi) % R
    const_lin = (-const_lin) % R

    _s1 = (beta * s1 + l + gamma) % R
    _s1 = _s1 * ((beta * s2 + r + gamma) % R) % R * beta % R * alpha % R * zu % R

    _s2 = (beta * zeta + gamma + l) % R
    _s2 = _s2 * ((beta * vk.coset_shift % R * zeta + gamma + r) % R) % R
    _s2 = _s2 * (
        (beta * vk.coset_shift % R * vk.coset_shift % R * zeta + gamma + o) % R
    ) % R
    _s2 = (-(_s2 * alpha)) % R
    coeff_z = (alpha2_l1 + _s2) % R

    zeta_n2 = pow(zeta, n + 2, R)
    zeta_n2_zh = (-(zeta_n2 * zh_zeta)) % R
    zeta_2n4_zh = (-(zeta_n2 * zeta_n2 % R * zh_zeta)) % R
    zh = (-zh_zeta) % R

    points = [vk.ql, vk.qr, vk.qm, vk.qo, vk.qk, vk.s[2], proof.z,
              proof.h[0], proof.h[1], proof.h[2]]
    scalars = [l, r, l * r % R, o, 1, _s1, coeff_z,
               zh, zeta_n2_zh, zeta_2n4_zh]
    linearized_digest = _msm(points, scalars)

    digests = [linearized_digest, proof.lro[0], proof.lro[1], proof.lro[2],
               vk.s[0], vk.s[1]]
    claimed = [const_lin, l, r, o, s1, s2]

    folded_proof, folded_digest = fold_proof(
        digests, proof.batched_h, claimed, zeta,
        fr_bytes(zu), fs,
    )
    for pt in (folded_digest, proof.z, folded_proof[0], proof.z_shifted_h):
        fs.bind(U, g1_bytes(pt))
    u = fs.fr(U)

    shifted_zeta = zeta * vk.generator % R
    batch_verify_multi_points(
        [folded_digest, proof.z],
        [folded_proof, (proof.z_shifted_h, zu)],
        [zeta, shifted_zeta],
        u, vk,
    )


def verify_plonk(proof_bytes: bytes, vk_bytes: bytes, public_inputs) -> bool:
    """Byte-level entry point (reference verifier/src/plonk/mod.rs)."""
    vk = load_vk(vk_bytes)
    proof = load_proof(proof_bytes)
    verify_plonk_algebraic(vk, proof, public_inputs)
    return True
