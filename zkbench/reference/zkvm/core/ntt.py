"""Radix-2 NTT / coset LDE over KoalaBear (host path, numpy).

Conventions pinned to the reference's Plonky3 backend
(reference: crates/stark/src/kb31_poseidon2.rs `Radix2DitParallel` DFT,
`TwoAdicFriPcs`):

  * `ntt(coeffs)` evaluates over the size-n subgroup H generated by
    `two_adic_generator(log n)`, output in natural order:
        y[i] = sum_j c[j] * w^(i*j).
  * `coset_lde(evals, added_bits, shift)` interprets `evals` as evaluations
    over H (natural order), and returns evaluations over the coset
    `shift * H'` with |H'| = n << added_bits, natural order.
  * Matrices are (n, width); the transform acts column-wise.

All arithmetic on uint64 intermediates, canonical uint32 in/out.
"""

from __future__ import annotations

import numpy as np

from . import field as F

P = np.uint64(F.P_INT)

_ZPOW_CACHE: dict = {}


def _native():
    """native/hashing.cpp NTT fast path, None if unavailable."""
    from . import p2_native

    return p2_native if p2_native.available() else None


def _butterflies(a: np.ndarray, root: int, log_n: int) -> np.ndarray:
    """In-place DIT butterflies on bit-reversed input `a` (n, w) uint64."""
    n = a.shape[0]
    for stage in range(log_n):
        half = 1 << stage
        span = half << 1
        w_span = pow(root, n // span, F.P_INT)
        tw = np.empty(half, dtype=np.uint64)
        acc = 1
        for i in range(half):
            tw[i] = acc
            acc = (acc * w_span) % F.P_INT
        blocks = a.reshape(n // span, span, -1)
        lo = blocks[:, :half, :]
        hi = blocks[:, half:, :]
        t = (hi * tw[None, :, None]) % P
        new_hi = (lo + (P - t)) % P
        lo += t
        lo %= P
        hi[...] = new_hi
    return a


def ntt(coeffs: np.ndarray) -> np.ndarray:
    """Coefficients -> evaluations over the subgroup, natural order. (n, w)."""
    coeffs = np.asarray(coeffs, dtype=np.uint32)
    squeeze = coeffs.ndim == 1
    if squeeze:
        coeffs = coeffs[:, None]
    n = coeffs.shape[0]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    if n == 1:
        out = coeffs.astype(np.uint32)
        return out[:, 0] if squeeze else out
    root = F.two_adic_generator(log_n)
    br = coeffs[F.bit_reverse_indices(log_n)]
    if n >= 256:
        nat = _native()
        if nat is not None:
            out = nat.ntt_bitrev(br, root)
            return out[:, 0] if squeeze else out
    out = _butterflies(br.astype(np.uint64), root, log_n).astype(np.uint32)
    return out[:, 0] if squeeze else out


def intt(evals: np.ndarray) -> np.ndarray:
    """Evaluations over the subgroup (natural order) -> coefficients."""
    evals = np.asarray(evals, dtype=np.uint32)
    squeeze = evals.ndim == 1
    if squeeze:
        evals = evals[:, None]
    n = evals.shape[0]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    if n == 1:
        out = evals.astype(np.uint32)
        return out[:, 0] if squeeze else out
    root_inv = pow(F.two_adic_generator(log_n), F.P_INT - 2, F.P_INT)
    n_inv = pow(n, F.P_INT - 2, F.P_INT)
    br = evals[F.bit_reverse_indices(log_n)]
    if n >= 256:
        nat = _native()
        if nat is not None:
            out = nat.ntt_bitrev(br, root_inv, n_inv)
            return out[:, 0] if squeeze else out
    a = _butterflies(br.astype(np.uint64), root_inv, log_n)
    out = ((a * np.uint64(n_inv)) % P).astype(np.uint32)
    return out[:, 0] if squeeze else out


def coset_lde(evals: np.ndarray, added_bits: int, shift: int) -> np.ndarray:
    """LDE: evals over H (natural) -> evals over shift*H' (natural), |H'| = n<<bits."""
    evals = np.asarray(evals, dtype=np.uint32)
    squeeze = evals.ndim == 1
    if squeeze:
        evals = evals[:, None]
    n = evals.shape[0]
    coeffs = intt(evals).astype(np.uint64)
    big_n = n << added_bits
    ext = np.zeros((big_n, coeffs.shape[1]), dtype=np.uint64)
    # scale coefficient j by shift^j so evaluation over H' hits the coset
    sh = F.powers(shift, n).astype(np.uint64)
    ext[:n] = (coeffs * sh[:, None]) % P
    out = ntt(ext.astype(np.uint32))
    return out[:, 0] if squeeze else out


def coset_eval(coeffs: np.ndarray, added_bits: int, shift: int) -> np.ndarray:
    """Coefficients (n, w) -> evaluations over shift*H', |H'| = n << added_bits."""
    coeffs = np.asarray(coeffs, dtype=np.uint64)
    n = coeffs.shape[0]
    big_n = n << added_bits
    ext = np.zeros((big_n, coeffs.shape[1]), dtype=np.uint64)
    sh = F.powers(shift, n).astype(np.uint64)
    ext[:n] = (coeffs * sh[:, None]) % P
    return ntt(ext.astype(np.uint32))


def _z_power_table(z: np.ndarray, n: int) -> np.ndarray:
    """z_pows[i] = z^i, (n, 4); built by doubling and cached per point (the
    prover opens many matrices at the same zeta / zeta_next)."""
    from . import ext as E

    key = np.asarray(z, np.uint32).tobytes()
    cached = _ZPOW_CACHE.get(key)
    if cached is None or cached.shape[0] < n:
        z_pows = E.eone((1,))
        while z_pows.shape[0] < n:
            k = z_pows.shape[0]
            zk = E.epow(z, k)
            z_pows = np.concatenate(
                [z_pows, E.emul(z_pows, zk[None, :])], axis=0
            )
        if len(_ZPOW_CACHE) > 16:
            _ZPOW_CACHE.clear()
        _ZPOW_CACHE[key] = z_pows
        cached = z_pows
    return cached[:n]


def eval_at_ext_points(coeffs: np.ndarray, zs) -> list:
    """Evaluate column polys at several extension points with ONE limb
    split of coeffs and one batched mod-matmul. coeffs (n, w) ->
    [(w, 4)] per point. 16-bit limb split keeps uint64 sums exact (limb
    products < 2^32; n <= 2^24 terms -> sums < 2^56)."""
    coeffs = np.asarray(coeffs, dtype=np.uint64)
    n = coeffs.shape[0]
    zp = np.hstack([_z_power_table(z, n).astype(np.uint64) for z in zs])
    c_lo, c_hi = coeffs & 0xFFFF, coeffs >> 16
    z_lo, z_hi = zp & 0xFFFF, zp >> 16
    s00 = c_lo.T @ z_lo
    s01 = c_lo.T @ z_hi
    s10 = c_hi.T @ z_lo
    s11 = c_hi.T @ z_hi
    out = (
        s00 % P
        + (((s01 % P) << np.uint64(16)) % P)
        + (((s10 % P) << np.uint64(16)) % P)
        + (((s11 % P) << np.uint64(32)) % P)
    ) % P
    out = out.astype(np.uint32)
    return [out[:, 4 * i: 4 * i + 4] for i in range(len(zs))]


def eval_at_ext_point(coeffs: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Evaluate column polys at an extension point. coeffs (n, w) -> (w, 4)."""
    return eval_at_ext_points(coeffs, [z])[0]


def vanishing_poly_at(log_n: int, shift: int, z: np.ndarray) -> np.ndarray:
    """Z_H(z) = (z/shift)^n - 1 evaluated at ext point z. Returns (4,)."""
    from . import ext as E

    shift_inv = pow(int(shift), F.P_INT - 2, F.P_INT)
    zs = E.emul_base(z, np.uint32(shift_inv))
    zn = E.epow(zs, 1 << log_n)
    return E.esub(zn, E.eone())
