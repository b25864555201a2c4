"""Keccak-f[1600] permutation AIR: one row per round, 24 rows per
permutation, fully bit-decomposed state
(reference: crates/core/machine/src/syscall/precompiles/keccak/air.rs wraps
the same round structure; the bit-plane layout here is designed around this
engine's degree-3 budget rather than ported).

Row layout (all bits):
  round[24]   one-hot round counter, cycling r -> r+1 mod 24 down the trace
  a[25*64]    state at the round input, lane l = x + 5y, bit z at l*64 + z
  c[5*64]     theta column parities: c[x,z] = parity_y a[x,y,z], enforced by
              the diff-in-{0,2,4} trick: (s-c)(s-c-2)(s-c-4) = 0, s = sum_y a
  ap[25*64]   a' = a xor d, d[x,z] = c[x-1,z] xor c[x+1,z-1]  (degree-3 xor)
  chi00[64]   chi output of lane (0,0) before iota (committed so the iota
              xor with the round-selected RC bit stays degree 2)
  aout[25*64] the round output (committed; equals the chi/rho/pi expression,
              degree 3); the next row's `a` must equal `aout` unless this is
              round 23 (gated degree 2)

A permutation chain can be cut by the power-of-two padding mid-permutation;
every in-trace transition still satisfies the constraints because padding
rows continue Keccak-f chains of the zero state.
"""

from __future__ import annotations

import numpy as np

from ..executor.keccak import RC, ROT, keccak_round
from ..stark.chip import Air
from .layout import Layout, trace_height

NR = 24


def add_perm_layout(l: Layout) -> Layout:
    """The shared permutation column block (used by the standalone chip and
    the sponge precompile chip)."""
    return (
        l.add("round", NR)
        .add("a", 1600)
        .add("c", 320)
        .add("ap", 1600)
        .add("chi00", 64)
        .add("aout", 1600)
    )


COLS = add_perm_layout(Layout())

RC_BITS = np.array(
    [[(RC[r] >> z) & 1 for z in range(64)] for r in range(NR)], dtype=np.uint32
)


def _lane_bits(v: int) -> list:
    return [(v >> z) & 1 for z in range(64)]


def _bits_to_row(states_25: list) -> np.ndarray:
    out = np.zeros(1600, dtype=np.uint32)
    for l in range(25):
        out[64 * l : 64 * l + 64] = _lane_bits(int(states_25[l]))
    return out


def _theta(a25: list):
    c = [a25[x] ^ a25[x + 5] ^ a25[x + 10] ^ a25[x + 15] ^ a25[x + 20] for x in range(5)]
    M64 = (1 << 64) - 1
    rol = lambda v, r: ((v << r) | (v >> (64 - r))) & M64 if r else v
    d = [c[(x - 1) % 5] ^ rol(c[(x + 1) % 5], 1) for x in range(5)]
    ap = [a25[l] ^ d[l % 5] for l in range(25)]  # lane index l = x + 5y
    return c, ap


def _chi_input_bit(ap_bits, u, v, z):
    """b[u + 5v] bit z = rotated a' bit (rho + pi wiring)."""
    x = (3 * v + u) % 5
    lane = x + 5 * u
    r = ROT[x][u]
    return ap_bits[64 * lane + (z - r) % 64]


def fill_perm_row(row: np.ndarray, layout: Layout, cur: list, rnd: int) -> list:
    """Write one round row's permutation columns; returns the round output."""
    c_lanes, ap_lanes = _theta(cur)
    nxt = keccak_round(cur, rnd)
    chi00 = nxt[0] ^ RC[rnd]
    row[layout.slc("round")][rnd] = 1
    row[layout.slc("a")] = _bits_to_row(cur)
    cb = np.zeros(320, dtype=np.uint32)
    for x in range(5):
        cb[64 * x : 64 * x + 64] = _lane_bits(int(c_lanes[x]))
    row[layout.slc("c")] = cb
    row[layout.slc("ap")] = _bits_to_row(ap_lanes)
    row[layout.slc("chi00")] = _lane_bits(int(chi00))
    row[layout.slc("aout")] = _bits_to_row(nxt)
    return nxt


def fill_perm_padding(mat: np.ndarray, layout: Layout, start_row: int):
    """Fill rows [start_row:] with zero-state Keccak-f chains so the ungated
    permutation constraints hold on padding."""
    cur, rnd = [0] * 25, 0
    for row in range(start_row, mat.shape[0]):
        cur = fill_perm_row(mat[row], layout, cur, rnd)
        rnd += 1
        if rnd == NR:
            rnd, cur = 0, [0] * 25


def eval_perm(b, L, N):
    """The shared round constraints: round-flag cycling, theta parity, a',
    chi/iota, and the intra-permutation chain (gated off on round 23)."""
    R = L["round"]
    acc = 0
    for r in range(NR):
        b.assert_bool(R[r])
        acc = R[r] + acc
    b.assert_eq(acc, 1)
    b.when_first_row().assert_eq(R[0], 1)
    NRnd = N["round"]
    for r in range(NR):
        b.when_transition().assert_eq(NRnd[r], R[(r + NR - 1) % NR])

    a = L["a"]
    c = L["c"]
    ap = L["ap"]
    aout = L["aout"]
    chi00 = L["chi00"]
    for i in range(1600):
        b.assert_bool(a[i])
    for i in range(320):
        b.assert_bool(c[i])
    # theta parity: sum_y a[x,y,z] differs from c[x,z] by 0, 2 or 4
    for x in range(5):
        for z in range(64):
            s = 0
            for y in range(5):
                s = a[64 * (x + 5 * y) + z] + s
            diff = s - c[64 * x + z]
            b.assert_zero(diff * (diff - 2) * (diff - 4))
    # a' = a xor d,  d[x,z] = c[x-1,z] xor c[x+1,z-1]
    for x in range(5):
        for z in range(64):
            c1 = c[64 * ((x + 4) % 5) + z]
            c2 = c[64 * ((x + 1) % 5) + (z + 63) % 64]
            d = c1 + c2 - 2 * c1 * c2
            for y in range(5):
                i = 64 * (x + 5 * y) + z
                b.assert_eq(ap[i], a[i] + d - 2 * a[i] * d)
    # chi (+ iota on lane (0,0) via the committed chi00 plane)
    for v in range(5):
        for u in range(5):
            for z in range(64):
                b0 = _chi_input_bit(ap, u, v, z)
                b1 = _chi_input_bit(ap, (u + 1) % 5, v, z)
                b2 = _chi_input_bit(ap, (u + 2) % 5, v, z)
                p = (1 - b1) * b2
                e = b0 + p - 2 * b0 * p
                if u == 0 and v == 0:
                    b.assert_eq(chi00[z], e)
                    rc = sum(
                        R[r] * int(RC_BITS[r][z])
                        for r in range(NR)
                        if RC_BITS[r][z]
                    )
                    b.assert_eq(aout[z], chi00[z] + rc - 2 * chi00[z] * rc)
                else:
                    b.assert_eq(aout[64 * (u + 5 * v) + z], e)
    # chain: within a permutation the next row's state is this round's out
    not_last = 1 - R[NR - 1]
    Na = N["a"]
    for i in range(1600):
        b.when_transition().assert_zero(not_last * (Na[i] - aout[i]))


class KeccakPermAir(Air):
    name = "KeccakPerm"
    width = COLS.width

    def generate_trace(self, record, output):
        states = [list(s) for s in record.states]
        n_real = NR * len(states)
        height = trace_height(n_real, 32)
        mat = np.zeros((height, COLS.width), dtype=np.uint32)
        row = 0
        for st in states:
            cur = list(st)
            for rnd in range(NR):
                cur = fill_perm_row(mat[row], COLS, cur, rnd)
                row += 1
        fill_perm_padding(mat, COLS, row)
        return mat

    def eval(self, b):
        L = COLS.view(b.main_local)
        N = COLS.view(b.main_next)
        eval_perm(b, L, N)
