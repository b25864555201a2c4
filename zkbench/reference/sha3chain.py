"""What programs/sha3chain.py outputs: `rounds` rounds of Keccak-256 over
the 32 bytes read from stdin, and its cycle count, one cycle an instruction:
13 before the loop (HINT_READ's four, two bases, the padding's and the
length word's six, the counter), 24 a round (16 to copy the digest, 5 for
the KECCAK_SPONGE syscall, 3 for the loop), 32 to commit and 3 to halt.

Keccak-256 is the original Keccak's (its padding 0x01 .. 0x80, as the
reference's guest calls `keccak256`), not SHA3-256, whose padding is 0x06
.. 0x80: so not hashlib.sha3_256. Keccak-f[1600] is written here from FIPS
202, section 3: the rho offsets from the (x, y) walk of 3.2.2 and the round
constants from the rc(t) LFSR of 3.2.5. The hint lands in memory as
little-endian words and the sponge reads its lanes little-endian, so the
first message is the 32 bytes as read; the committed words are the digest's
bytes as little-endian 32-bit words."""

from __future__ import annotations

M64 = (1 << 64) - 1
RATE = 136  # bytes: 1600 - 2 * 256 bits


def _rc(t: int) -> int:
    """FIPS 202 Algorithm 5: the bit rc(t) of the LFSR x^8 + x^6 + x^5 + x^4 + 1."""
    if t % 255 == 0:
        return 1
    r = [1, 0, 0, 0, 0, 0, 0, 0]
    for _ in range(t % 255):
        r = [0] + r
        for k in (0, 4, 5, 6):
            r[k] ^= r[8]
        r = r[:8]
    return r[0]


ROUND_CONSTANTS = [sum(_rc(j + 7 * i) << ((1 << j) - 1) for j in range(7)) for i in range(24)]


def _rho_offsets() -> list:
    """FIPS 202 Algorithm 2: the offset of lane x + 5y, (t + 1)(t + 2) / 2 mod 64
    along the walk from (1, 0)."""
    off = [0] * 25
    x, y = 1, 0
    for t in range(24):
        off[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return off


RHO = _rho_offsets()


def _rot(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & M64 if n else v


def keccak_f(a: list) -> list:
    """Keccak-f[1600] on 25 lanes, lane (x, y) at x + 5y."""
    a = list(a)
    for rc in ROUND_CONSTANTS:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rot(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]  # theta
        a = [_rot(a[i], RHO[i]) for i in range(25)]  # rho
        a = [a[(x + 3 * y) % 5 + 5 * x] for y in range(5) for x in range(5)]  # pi
        a = [a[x + 5 * y] ^ (~a[(x + 1) % 5 + 5 * y] & a[(x + 2) % 5 + 5 * y])
             for y in range(5) for x in range(5)]  # chi
        a[0] ^= rc  # iota
    return a


def keccak256(data: bytes) -> bytes:
    padded = bytearray(data) + bytes(RATE - len(data) % RATE)
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    state = [0] * 25
    for off in range(0, len(padded), RATE):
        for i in range(RATE // 8):
            state[i] ^= int.from_bytes(padded[off + 8 * i : off + 8 * i + 8], "little")
        state = keccak_f(state)
    return b"".join(v.to_bytes(8, "little") for v in state[:4])


def expected(buffers, rounds: int) -> dict:
    (msg,) = buffers
    for _ in range(rounds):
        msg = keccak256(msg)
    out = [int.from_bytes(msg[i : i + 4], "little") for i in range(0, 32, 4)]
    return {"words": out, "cycles": 13 + 24 * rounds + 32 + 3}
