"""Host hook registry: guest WRITEs to reserved fds invoke host callbacks
whose result buffers become the next hint reads (reference:
crates/core/executor/src/hook.rs:41 HookRegistry, fd numbers from
crates/primitives/src/consts.rs fd module).

Default hooks (reference hook.rs:71-86):
  fd 5  FD_ECRECOVER_HOOK   — secp256k1/r1 decompress + scalar inverse
  fd 7  FD_FP_SQRT          — generic Tonelli-Shanks sqrt witness
  fd 8  FD_FP_INV           — generic Fermat inverse witness
  fd 9  FD_BLS12_381_SQRT   — bls12-381 base-field sqrt witness
  fd 10 FD_BLS12_381_INVERSE— bls12-381 base-field inverse witness
"""

from __future__ import annotations

FD_ECRECOVER_HOOK = 5
FD_EDDECOMPRESS = 6
FD_FP_SQRT = 7
FD_FP_INV = 8
FD_BLS12_381_SQRT = 9
FD_BLS12_381_INVERSE = 10

_P256K1 = (1 << 256) - (1 << 32) - 977
_N256K1 = int(
    "fffffffffffffffffffffffffffffffebaaedce6af48a03bbfd25e8cd0364141", 16
)
_P256R1 = (1 << 256) - (1 << 224) + (1 << 192) + (1 << 96) - 1
_N256R1 = int(
    "ffffffff00000000ffffffffffffffffbce6faada7179e84f3b9cac2fc632551", 16
)
_PBLS = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab", 16
)
_NQR = 3  # non-quadratic residue used by the reference for k256/p256


def _be(v: int, n: int) -> bytes:
    return int(v).to_bytes(n, "big")


def _legendre(a: int, p: int) -> int:
    return pow(a, (p - 1) // 2, p)


def _sqrt_fp(a: int, p: int, nqr: int):
    """Square root mod p, or None if `a` is a non-residue (reference
    hook.rs sqrt_fp: p = 3 mod 4 fast path, Tonelli-Shanks otherwise)."""
    a %= p
    if a == 0:
        return 0
    if p % 4 == 3:
        r = pow(a, (p + 1) // 4, p)
        return r if r * r % p == a else None
    if _legendre(a, p) != 1:
        return None
    s, q = 0, p - 1
    while q % 2 == 0:
        s += 1
        q //= 2
    c = pow(nqr, q, p)
    r = pow(a, (q + 1) // 2, p)
    t = pow(a, q, p)
    m = s
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
            assert i < m
        b = pow(c, 1 << (m - i - 1), p)
        r = r * b % p
        t = t * b * b % p
        c = b * b % p
        m = i
    return r


def hook_ecrecover(ex, buf: bytes) -> list:
    """[curve_id|odd<<7, r(32), alpha(32)] -> [1, y, r_inv] or [0, nqr_root]
    (reference hook.rs:118 hook_ecrecover)."""
    assert len(buf) == 65, "ecrecover hook buffer must be 65 bytes"
    curve_id = buf[0] & 0x7F
    r_y_is_odd = bool(buf[0] & 0x80)
    r = int.from_bytes(buf[1:33], "big")
    alpha = int.from_bytes(buf[33:65], "big")
    p, n = {1: (_P256K1, _N256K1), 2: (_P256R1, _N256R1)}[curve_id]
    assert r % n != 0 and alpha % p != 0
    y = _sqrt_fp(alpha, p, _NQR)
    if y is None:
        root = _sqrt_fp(alpha * _NQR % p, p, _NQR)
        return [b"\x00", _be(root, 32)]
    if r_y_is_odd != bool(y & 1):
        y = (-y) % p
    r_inv = pow(r % n, n - 2, n)
    return [b"\x01", _be(y, 32), _be(r_inv, 32)]


def hook_fp_inv(ex, buf: bytes) -> list:
    """[len_be4, element, modulus] -> [inverse] (reference hook_fp_inverse)."""
    assert len(buf) >= 4
    ln = int.from_bytes(buf[0:4], "big")
    assert len(buf) == 4 + 2 * ln, "fp_inv: bad buffer length"
    el = int.from_bytes(buf[4 : 4 + ln], "big")
    mod = int.from_bytes(buf[4 + ln :], "big")
    assert el != 0, "fp_inv of zero"
    return [_be(pow(el, mod - 2, mod), ln)]


def hook_fp_sqrt(ex, buf: bytes) -> list:
    """[len_be4, element, modulus, nqr] -> [status, root]: root of element
    (status 1) or of nqr*element (status 0) (reference hook_fp_sqrt)."""
    assert len(buf) >= 4
    ln = int.from_bytes(buf[0:4], "big")
    assert len(buf) == 4 + 3 * ln, "fp_sqrt: bad buffer length"
    el = int.from_bytes(buf[4 : 4 + ln], "big")
    mod = int.from_bytes(buf[4 + ln : 4 + 2 * ln], "big")
    nqr = int.from_bytes(buf[4 + 2 * ln :], "big")
    assert el < mod and nqr < mod, "fp_sqrt: non-canonical input"
    if el == 0:
        return [b"\x01", bytes(ln)]
    root = _sqrt_fp(el, mod, nqr)
    if root is not None:
        return [b"\x01", _be(root, ln)]
    root = _sqrt_fp(nqr * el % mod, mod, nqr)
    return [b"\x00", _be(root, ln)]


def hook_bls_sqrt(ex, buf: bytes) -> list:
    """48-byte bls12-381 base-field element -> [status, root(48)]."""
    assert len(buf) == 48
    return hook_fp_sqrt(
        ex, (48).to_bytes(4, "big") + buf + _be(_PBLS, 48) + _be(_NQR, 48)
    )


def hook_bls_inverse(ex, buf: bytes) -> list:
    """48-byte bls12-381 base-field element -> [inverse(48)]."""
    assert len(buf) == 48
    return hook_fp_inv(ex, (48).to_bytes(4, "big") + buf + _be(_PBLS, 48))


class HookRegistry:
    """fd -> hook(executor, bytes) -> list[bytes]; results append to the
    guest's hint input stream in order."""

    def __init__(self, table=None):
        self.table = dict(table or {})

    @classmethod
    def default(cls) -> "HookRegistry":
        return cls(
            {
                FD_ECRECOVER_HOOK: hook_ecrecover,
                FD_FP_SQRT: hook_fp_sqrt,
                FD_FP_INV: hook_fp_inv,
                FD_BLS12_381_SQRT: hook_bls_sqrt,
                FD_BLS12_381_INVERSE: hook_bls_inverse,
            }
        )

    def register(self, fd: int, fn) -> None:
        self.table[int(fd)] = fn

    def get(self, fd: int):
        return self.table.get(int(fd))
