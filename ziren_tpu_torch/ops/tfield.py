"""KoalaBear field arithmetic on torch tensors (counterpart of ops/jfield.py).

Representation: **canonical int64 in [0, p)**, p = 2^31 - 2^24 + 1. A
product of two reduced values is below 2^62, so every operation is one
plain tensor op followed by `% P` (torch's `%` is `remainder`: the result
takes the divisor's sign, so it stays in [0, p) after a subtraction). The
JAX package's Montgomery form and its 16-bit-limb mulhi emulation are not
needed: torch has native 64-bit products on every device.

Extension field: degree 4, x^4 = 3, layout (..., 4). `emul` is a single
outer product plus one gather-and-sum over the anti-diagonals, so it costs
six tensor ops whatever the batch shape.

Scalar operands may be Python ints (they ride along as kernel arguments
and need no host-to-device copy).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import field as F

P = F.P_INT
W = 3  # x^4 = W

_CONSTS: dict = {}


_CONSTS_MAX = 4096


def const(key, build, device) -> torch.Tensor:
    """Small per-device constant tensors built once from host numpy. Past
    _CONSTS_MAX entries the oldest quarter goes (a CUDA graph that reads
    one keeps its own reference)."""
    k = (key, torch.device(device))
    v = _CONSTS.get(k)
    if v is None:
        if len(_CONSTS) >= _CONSTS_MAX:
            for old in list(_CONSTS)[: _CONSTS_MAX // 4]:
                del _CONSTS[old]
        v = _CONSTS[k] = torch.as_tensor(np.asarray(build()), device=device)
    return v


def index(arr, device) -> torch.Tensor:
    """A host-built int64 array on `device`, uploaded once per content (the
    gather indices a shard's shape fixes): after the first prove of a shape
    its operations copy nothing from the host."""
    a = np.ascontiguousarray(arr, dtype=np.int64)
    return const(("index", a.shape, a.tobytes()), lambda: a, device)


def from_host(x, device) -> torch.Tensor:
    """Canonical host array -> int64 tensor on `device` (uploaded as 32-bit
    words, widened on the device: half the bytes over the bus)."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(a).to(device).long()


def to_host(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> canonical numpy uint32."""
    return x.cpu().numpy().astype(np.uint32)


def madd(a, b):
    return (a + b) % P


def msub(a, b):
    return (a - b) % P


def mneg(a):
    return (-a) % P


def mmul(a, b):
    return (a * b) % P


def mpow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a**e for a static integer exponent (square-and-multiply)."""
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mmul(result, base)
        e >>= 1
        if e:
            base = mmul(base, base)
    return result


def minv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse via Fermat (a^(p-2)); 0 maps to 0."""
    return mpow(a, P - 2)


# ---------------------------------------------------------------------------
# Quartic extension (x^4 = 3), layout (..., 4)
# ---------------------------------------------------------------------------


def _emul_tables():
    idx = np.zeros((4, 4), np.int64)
    wts = np.zeros((4, 4), np.int64)
    for k in range(4):
        for i in range(4):
            j = (k - i) % 4
            idx[k, i] = 4 * i + j
            wts[k, i] = W if i + j >= 4 else 1
    return idx, wts


_EMUL_IDX, _EMUL_W = _emul_tables()


def emul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Ext4 product of broadcastable (..., 4) tensors: c_k is the sum of
    a_i*b_j over i+j = k plus W times the sum over i+j = k+4."""
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)) % P  # (..., 4, 4), < p
    flat = prod.flatten(-2)
    idx = const("emul_idx", lambda: _EMUL_IDX, flat.device)
    wts = const("emul_w", lambda: _EMUL_W, flat.device)
    return (flat[..., idx] * wts).sum(-1) % P  # sum < 12 p


def eadd(a, b):
    return madd(a, b)


def esub(a, b):
    return msub(a, b)


def emul_base(a: torch.Tensor, b) -> torch.Tensor:
    """ext (..., 4) * base (...,) or Python int."""
    if isinstance(b, torch.Tensor):
        b = b.unsqueeze(-1)
    return (a * b) % P


def efrom_base(a: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(a.unsqueeze(-1), (0, 3))


_GAMMA = pow(3, (P - 1) // 4, P)


def efrobenius(a: torch.Tensor, k: int = 1) -> torch.Tensor:
    g = const(
        ("frob", k),
        lambda: np.array([pow(_GAMMA, k * i, P) for i in range(4)], np.int64),
        a.device,
    )
    return (a * g) % P


def einv(a: torch.Tensor) -> torch.Tensor:
    """Ext4 inverse via the norm map; zero maps to zero."""
    b = emul(efrobenius(a, 1), efrobenius(a, 2))
    b = emul(b, efrobenius(a, 3))
    norm = emul(a, b)[..., 0]
    return emul_base(b, minv(norm))
