"""Poseidon2-KoalaBear-16 on torch tensors (counterpart of ops/jposeidon2.py).

`permute`, `hash_rows` and `compress_pairs` route by the tensor's device:
a CUDA tensor goes to the hand-written kernels in `ziren_tpu_torch.kernels`
(csrc/poseidon2.cu), a CPU tensor to the plain PyTorch version below,
which is also the oracle the kernels are held against on the card. Values
are canonical int64; bit-identical to `ziren_tpu.core.poseidon2`.
"""

from __future__ import annotations

import torch

from ziren_tpu.core import poseidon2 as hp2
from . import tfield as tf

WIDTH = 16
RATE = 8
OUT = 8
P = tf.P


def _rc_cols(device):
    """Round constants as (21, 16, 1) columns."""
    return tf.const("p2_rc_cols", lambda: hp2.RC.astype("int64")[:, :, None], device)


def _diag_col(device):
    return tf.const(
        "p2_diag_col", lambda: hp2.INTERNAL_DIAG.astype("int64")[:, None], device
    )


# The plain permutation works on the state word-major, (16, m): each word is
# one contiguous row, so every tensor op streams whole rows.


def _external_linear_layer(s: torch.Tensor) -> torch.Tensor:
    """M_E on a (16, m) state: the M4 circulant on each block of four words,
    then each word adds the sum of its position over the four blocks.
    Unreduced sums stay below 35 p < 2^37; one reduction at the end."""
    x0, x1, x2, x3 = s.view(4, 4, -1).unbind(1)  # (block, m) per position
    t01 = x0 + x1
    t23 = x2 + x3
    t0123 = t01 + t23
    t01123 = t0123 + x1
    t01233 = t0123 + x3
    o = torch.stack(
        [t01123 + t01, t01123 + 2 * x2, t01233 + t23, t01233 + 2 * x0], dim=1
    )
    o += o.sum(0, keepdim=True)
    return o.view(WIDTH, -1).remainder_(P)


def _sbox(x: torch.Tensor) -> torch.Tensor:
    """x^3 of a reduced x (an unreduced x < 2p would overflow x*x)."""
    y = (x * x).remainder_(P)
    return y.mul_(x).remainder_(P)


def _external_round(s: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    return _external_linear_layer(_sbox((s + rc).remainder_(P)))


def _permute_words(s: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of a word-major (16, m) state."""
    rc = _rc_cols(s.device)
    diag = _diag_col(s.device)
    s = _external_linear_layer(s)
    for r in range(4):
        s = _external_round(s, rc[r])
    for r in range(4, 17):
        s[0] = _sbox((s[0] + rc[r, 0]).remainder_(P))
        s = (s * diag).add_(s.sum(0)).remainder_(P)
    for r in range(17, 21):
        s = _external_round(s, rc[r])
    return s


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation on (..., 16), plain PyTorch."""
    words = _permute_words(state.reshape(-1, WIDTH).t().contiguous())
    return words.t().contiguous().reshape(state.shape)


def hash_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """PaddingFreeSponge over rows, plain PyTorch: (n, w) -> (n, 8)."""
    n, w = rows.shape
    cols = rows.t()
    s = torch.zeros((WIDTH, n), dtype=torch.int64, device=rows.device)
    for c in range(0, w, RATE):
        chunk = cols[c : c + RATE]
        s = _permute_words(torch.cat([chunk, s[chunk.shape[0] :]]))
    return s[:OUT].t().contiguous()


def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain)."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"poseidon2: unsupported device {x.device}")
    return False


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation on (..., 16)."""
    if not _on_cuda(state):
        return permute_plain(state)
    from ziren_tpu_torch import kernels

    return kernels.permute(state.reshape(-1, WIDTH).contiguous()).reshape(state.shape)


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """PaddingFreeSponge over rows: (n, w) -> (n, 8) digests."""
    if not _on_cuda(rows):
        return hash_rows_plain(rows)
    from ziren_tpu_torch import kernels

    return kernels.hash_rows(rows.contiguous())


def compress_pairs(digests: torch.Tensor) -> torch.Tensor:
    """(2k, 8) digests -> (k, 8): perm(concat of adjacent pairs)[:8]."""
    k = digests.shape[0] // 2
    return permute(digests.reshape(k, WIDTH))[:, :OUT]


def compress2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(k, 8), (k, 8) -> (k, 8): perm(a || b)[:8] row by row."""
    return permute(torch.cat([a, b], dim=1))[:, :OUT]
