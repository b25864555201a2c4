"""Poseidon2 permutation over KoalaBear, width 16 (host path, numpy).

Exact semantics of the reference's `Poseidon2KoalaBear<16>` as pinned by its
AIR (reference: crates/core/machine/src/operations/poseidon2/air.rs):

  * initial external linear layer applied to the input state
  * 4 initial external rounds: +RC[r], x^3 sbox (all lanes), external layer
  * 13 internal rounds: +RC[4+r][0] on lane 0, x^3 on lane 0, then
    state[i] = diag[i]*state[i] + sum(state)
  * 4 terminal external rounds with RC rows 17..20

The external linear layer applies the 4x4 matrix
  [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]]
blockwise then adds the per-position-block column sums (apply_m_4_mut /
external_linear_layer_mut in the reference AIR).

Sponge constructions (reference: crates/stark/src/kb31_poseidon2.rs):
  * hash   = PaddingFreeSponge<perm, 16, 8, 8>: overwrite-absorb in rate-8
    chunks (permuting after each, including a final partial chunk), squeeze
    state[..8].
  * compress = TruncatedPermutation<perm, 2, 8, 16>: perm(l || r)[..8].

All functions are vectorized: `state` has shape (..., 16) uint32 canonical.
"""

from __future__ import annotations

import numpy as np

from . import field as F
from .poseidon2_constants import RC_16_30

WIDTH = 16
RATE = 8
OUT = 8
NUM_EXTERNAL_ROUNDS = 8
NUM_INTERNAL_ROUNDS = 13

P = F.P_INT

# internal diagonal (reference: operations/poseidon2/air.rs INTERNAL_DIAG_MONTY_16)
INTERNAL_DIAG = np.array(
    [
        P - 2,
        1,
        2,
        (P + 1) >> 1,
        3,
        4,
        (P - 1) >> 1,
        P - 3,
        P - 4,
        P - ((P - 1) >> 8),
        P - ((P - 1) >> 3),
        P - 127,
        (P - 1) >> 8,
        (P - 1) >> 3,
        (P - 1) >> 4,
        127,
    ],
    dtype=np.uint32,
)

RC = np.array(RC_16_30, dtype=np.uint32)  # (30, 16)


def _build_external_matrix() -> np.ndarray:
    """The 16x16 M_E matrix: diagonal blocks 2*M4, off-diagonal M4."""
    m4 = np.array(
        [[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]], dtype=np.float64
    )
    m = np.zeros((16, 16), dtype=np.float64)
    for bi in range(4):
        for bj in range(4):
            m[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = (
                2 * m4 if bi == bj else m4
            )
    return m.T  # row-vector convention: out = x @ M^T


_M_EXT_T = _build_external_matrix()


def _external_linear_layer(x: np.ndarray) -> np.ndarray:
    """M_E as an exact float64 BLAS matmul: inputs < 2^31, matrix entries
    <= 6, dot sums < 2^38 < 2^53 so float64 is exact; reduce mod p after."""
    out = x.astype(np.float64) @ _M_EXT_T
    out = out.astype(np.uint64)
    out %= P
    return out


def _sbox64(x: np.ndarray) -> np.ndarray:
    """x^3 mod p; input < 2^32 (unreduced sums are fine), output < p."""
    x2 = (x * x) % P
    x2 *= x
    x2 %= P
    return x2


def _sbox(x: np.ndarray) -> np.ndarray:
    return _sbox64(x.astype(np.uint64)).astype(np.uint32)


_RC64 = RC.astype(np.uint64)
_DIAG64 = INTERNAL_DIAG.astype(np.uint64)


def _native():
    """native/hashing.cpp fast path (multithreaded C++), None if unavailable."""
    from . import p2_native

    return p2_native if p2_native.available() else None


def permute(state: np.ndarray) -> np.ndarray:
    """Poseidon2 permutation; state shape (..., 16) canonical uint32."""
    state = np.asarray(state, dtype=np.uint32)
    assert state.shape[-1] == WIDTH
    if state.ndim > 1 and state.size >= 64 * WIDTH:
        nat = _native()
        if nat is not None:
            return nat.permute(state)
    x = _external_linear_layer(state.astype(np.uint64))
    # initial external rounds (RC rows 0..3)
    for r in range(NUM_EXTERNAL_ROUNDS // 2):
        x = _external_linear_layer(_sbox64(x + _RC64[r]))
    # internal rounds (RC rows 4..16, element 0)
    for r in range(NUM_INTERNAL_ROUNDS):
        x[..., 0] = _sbox64(x[..., 0] + _RC64[4 + r][0])
        # matmul_internal: state[i] = diag[i]*state[i] + sum(state)
        total = np.sum(x, axis=-1)  # < 16 * 2^31 = 2^35
        x = (x * _DIAG64) % P  # products < 2^62
        x += total[..., None]
        x %= P
    # terminal external rounds (RC rows 17..20)
    for r in range(NUM_EXTERNAL_ROUNDS // 2):
        x = _external_linear_layer(_sbox64(x + _RC64[17 + r]))
    return x.astype(np.uint32)


def hash_iter(inputs) -> np.ndarray:
    """PaddingFreeSponge hash of a flat sequence of field elements -> (8,)."""
    inputs = np.asarray(list(inputs), dtype=np.uint32).reshape(-1)
    state = np.zeros(WIDTH, dtype=np.uint32)
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i : i + RATE]
        state[: len(chunk)] = chunk
        state = permute(state)
    return state[:OUT].copy()


def hash_rows(rows: np.ndarray) -> np.ndarray:
    """Vectorized PaddingFreeSponge over rows: (n, w) -> (n, 8)."""
    rows = np.asarray(rows, dtype=np.uint32)
    n, w = rows.shape
    if n >= 64:
        nat = _native()
        if nat is not None:
            return nat.hash_rows(rows)
    state = np.zeros((n, WIDTH), dtype=np.uint32)
    for i in range(0, w, RATE):
        chunk = rows[:, i : i + RATE]
        state[:, : chunk.shape[1]] = chunk
        state = permute(state)
    return state[:, :OUT].copy()


def compress(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """TruncatedPermutation 2-to-1: (..., 8), (..., 8) -> (..., 8)."""
    left = np.asarray(left, dtype=np.uint32)
    if left.ndim > 1 and left.size >= 64 * OUT:
        nat = _native()
        if nat is not None:
            return nat.compress(left, right).reshape(left.shape)
    state = np.concatenate(
        [np.asarray(left, dtype=np.uint32), np.asarray(right, dtype=np.uint32)],
        axis=-1,
    )
    return permute(state)[..., :OUT]
