"""Keccak-f[1600] permutation (host oracle for the KECCAK_SPONGE precompile,
reference: crates/core/executor/src/syscalls/precompiles/keccak/sponge.rs —
the permutation itself is the public FIPS-202 algorithm)."""

from __future__ import annotations

M64 = (1 << 64) - 1

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rol(x: int, r: int) -> int:
    r %= 64
    return ((x << r) | (x >> (64 - r))) & M64


def keccak_round(state: list, rnd: int) -> list:
    """One Keccak-f round (theta, rho+pi, chi, iota) on 25 lanes."""
    a = list(state)
    # theta
    c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
    d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
    for x in range(5):
        for y in range(5):
            a[x + 5 * y] ^= d[x]
    # rho + pi
    b = [0] * 25
    for x in range(5):
        for y in range(5):
            b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], ROT[x][y])
    # chi
    for x in range(5):
        for y in range(5):
            a[x + 5 * y] = b[x + 5 * y] ^ (
                (~b[(x + 1) % 5 + 5 * y] & M64) & b[(x + 2) % 5 + 5 * y]
            )
    # iota
    a[0] ^= RC[rnd]
    return a


def keccakf(state: list) -> list:
    """24-round Keccak-f[1600] on a 25-lane state (x + 5y indexing)."""
    a = list(state)
    for rnd in range(24):
        a = keccak_round(a, rnd)
    return a
