"""Radix-2 NTT / coset LDE through the device (counterpart of ops/jntt.py,
whose host-facing helpers these are: canonical numpy in, canonical numpy
out, bit-identical to core/ntt.py).

The butterflies are those of the commit path (tpcs.ntt_bitrev_in, tpcs.lde);
there is no second cascade here. `device` is the prover's: None is the GPU
and raises without one, "cpu" has to be named.
"""

from __future__ import annotations

import numpy as np

from ..stark.backend import resolve_device
from . import tfield as tf
from . import tpcs


def _transform(mat_np: np.ndarray, inverse: bool, device) -> np.ndarray:
    dev = resolve_device(device)
    log_n = mat_np.shape[0].bit_length() - 1
    x = tf.from_host(mat_np, dev)[tpcs.bitrev_idx(log_n, dev)]
    return tf.to_host(tpcs.ntt_bitrev_in(x, log_n, inverse=inverse))


def ntt(mat_np: np.ndarray, device=None) -> np.ndarray:
    """Canonical (n, w) coefficients -> evaluations over the subgroup."""
    return _transform(mat_np, False, device)


def intt(mat_np: np.ndarray, device=None) -> np.ndarray:
    """Canonical (n, w) evaluations over the subgroup -> coefficients."""
    return _transform(mat_np, True, device)


def coset_lde(evals_np: np.ndarray, added_bits: int, shift: int, device=None) -> np.ndarray:
    """(n, w) evaluations over the subgroup -> (n << added_bits, w)
    evaluations over shift * the larger subgroup, natural order."""
    dev = resolve_device(device)
    log_n = evals_np.shape[0].bit_length() - 1
    _coeffs, out, _br = tpcs.lde(tf.from_host(evals_np, dev), log_n, added_bits, int(shift), 1)
    return tf.to_host(out)
