"""Portable Groth16 verifier over gnark byte formats (reference:
crates/verifier/src/groth16/{converter,verify,mod}.rs).

Byte layouts (gnark-crypto bn254 marshal):
  * proof: ar (uncompressed G1, 64B) || bs (uncompressed G2, 128B with each
    Fq2 coordinate serialized c1 || c0 big-endian) || krs (uncompressed G1)
  * vk: alpha (compressed G1) || _ || beta (compressed G2) || gamma
    (compressed G2) || _ || delta (compressed G2) || num_k (u32 BE) || k[i]
    (compressed G1 each)
  * compressed points carry a 2-bit flag in the top bits of the first byte:
    10 = positive (lexicographically smaller y), 11 = negative, 01 = infinity.

The verification equation (verify.rs:62):
    e(-ar, bs) * e(prepared_inputs, gamma) * e(krs, delta)
        * e(alpha, -beta) == 1
with beta NEGATED at vk load time (converter.rs:52), so the batch here uses
+beta and negates alpha's pairing partner accordingly.
"""

from __future__ import annotations

import hashlib

from . import bn254_pairing as bp

MASK = 0b11 << 6
FLAG_POSITIVE = 0b10 << 6
FLAG_NEGATIVE = 0b11 << 6
FLAG_INFINITY = 0b01 << 6


class Groth16Error(Exception):
    pass


def _fq_from_be(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    if v >= bp.Q:
        raise Groth16Error("field element out of range")
    return v


def _deserialize_with_flags(buf: bytes):
    if len(buf) != 32:
        raise Groth16Error("bad compressed element length")
    flag = buf[0] & MASK
    if flag == FLAG_INFINITY:
        return 0, flag
    x = int.from_bytes(bytes([buf[0] & ~MASK & 0xFF]) + buf[1:], "big") % bp.Q
    return x, flag


def compressed_x_to_g1(buf: bytes):
    x, flag = _deserialize_with_flags(buf)
    if flag == FLAG_INFINITY:
        return None
    ys = bp.g1_y_from_x(x)
    if ys is None:
        raise Groth16Error("compressed G1 x not on curve")
    y_small, y_big = ys
    return (x, y_small if flag == FLAG_POSITIVE else y_big)


def compressed_x_to_g2(buf: bytes):
    if len(buf) != 64:
        raise Groth16Error("bad compressed G2 length")
    x1, flag = _deserialize_with_flags(buf[:32])
    x0 = int.from_bytes(buf[32:64], "big") % bp.Q
    if flag == FLAG_INFINITY:
        return None
    x = bp.FQ2((x0, x1))
    ys = bp.g2_y_from_x(x)
    if ys is None:
        raise Groth16Error("compressed G2 x not on curve")
    y_small, y_big = ys
    return (x, y_small if flag == FLAG_POSITIVE else y_big)


def uncompressed_g1(buf: bytes):
    if len(buf) != 64:
        raise Groth16Error("bad G1 length")
    pt = (_fq_from_be(buf[:32]), _fq_from_be(buf[32:]))
    if not bp.is_on_g1(pt):
        raise Groth16Error("G1 point not on curve")
    return pt


def uncompressed_g2(buf: bytes):
    if len(buf) != 128:
        raise Groth16Error("bad G2 length")
    x1, x0 = _fq_from_be(buf[0:32]), _fq_from_be(buf[32:64])
    y1, y0 = _fq_from_be(buf[64:96]), _fq_from_be(buf[96:128])
    pt = (bp.FQ2((x0, x1)), bp.FQ2((y0, y1)))
    if not bp.is_on_g2(pt):
        raise Groth16Error("G2 point not on curve")
    return pt


def load_proof(buf: bytes):
    """ar, bs, krs from the first 256 raw gnark proof bytes."""
    if len(buf) < 256:
        raise Groth16Error("proof too short")
    ar = uncompressed_g1(buf[:64])
    bs = uncompressed_g2(buf[64:192])
    krs = uncompressed_g1(buf[192:256])
    return ar, bs, krs


def load_vk(buf: bytes):
    """(alpha, neg_beta, gamma, delta, k[]) per converter.rs:29-54."""
    alpha = compressed_x_to_g1(buf[0:32])
    beta = compressed_x_to_g2(buf[64:128])
    gamma = compressed_x_to_g2(buf[128:192])
    delta = compressed_x_to_g2(buf[224:288])
    num_k = int.from_bytes(buf[288:292], "big")
    k = []
    off = 292
    for _ in range(num_k):
        k.append(compressed_x_to_g1(buf[off : off + 32]))
        off += 32
    return alpha, bp.g2_neg(beta), gamma, delta, k


def hash_public_inputs(public_values: bytes) -> bytes:
    """sha256 masked into the 254-bit field (reference utils.rs:7)."""
    d = bytearray(hashlib.sha256(bytes(public_values)).digest())
    d[0] &= 0x1F
    return bytes(d)


class Groth16Verifier:
    @staticmethod
    def verify_gnark_proof(proof: bytes, public_inputs, groth16_vk: bytes) -> bool:
        """proof: raw gnark bytes (no 4-byte prefix); public_inputs: list of
        ints < r (reference mod.rs:231 verify_gnark_proof)."""
        ar, bs, krs = load_proof(bytes(proof))
        alpha, neg_beta, gamma, delta, k = load_vk(bytes(groth16_vk))
        if len(public_inputs) + 1 != len(k):
            raise Groth16Error("public input count mismatch")
        acc = k[0]
        for inp, base in zip(public_inputs, k[1:]):
            inp = int(inp)
            if inp >= bp.R:
                raise Groth16Error("public input out of range")
            acc = bp._add(acc, bp.g1_mul(base, inp))
        ok = bp.pairing_batch(
            [
                (bp.g1_neg(ar), bs),
                (acc, gamma),
                (krs, delta),
                (alpha, bp.g2_neg(neg_beta)),
            ]
        )
        if not ok:
            raise Groth16Error("pairing check failed")
        return True

    @staticmethod
    def verify(proof: bytes, zkm_public_values: bytes, zkm_vkey_hash: str,
               groth16_vk: bytes) -> bool:
        """Ziren-flavoured entry (reference mod.rs:89): the proof carries a
        4-byte groth16-vk hash prefix; public inputs are [vkey_hash,
        sha256(public values) masked to the field]."""
        vk_hash = hashlib.sha256(bytes(groth16_vk)).digest()
        if bytes(proof[:4]) != vk_hash[:4]:
            raise Groth16Error("groth16 vk hash prefix mismatch")
        h = zkm_vkey_hash[2:] if zkm_vkey_hash.startswith("0x") else zkm_vkey_hash
        vkey = int.from_bytes(bytes.fromhex(h)[1:], "big")
        digest = int.from_bytes(hash_public_inputs(zkm_public_values), "big")
        return Groth16Verifier.verify_gnark_proof(
            bytes(proof[4:]), [vkey, digest], bytes(groth16_vk)
        )
