"""Port Poseidon2 (ziren_tpu_torch.ops.tposeidon2, plain PyTorch on the CPU)
== the JAX package's Pallas sponge (interpret mode), its XLA lowering and
the host numpy Poseidon2. Exact equality.
"""

import os

import numpy as np
import pytest
import torch

from ziren_tpu.core import field as F
from ziren_tpu.core import poseidon2 as hp2
from ziren_tpu.ops import jfield as jf
from ziren_tpu.ops import jposeidon2 as jp2
from ziren_tpu_torch.ops import tfield as tf
from ziren_tpu_torch.ops import tposeidon2 as tp2

# Under pytest-xdist each worker keeps to one torch thread: the workers
# already fill the cores, and torch's thread pool on top of them slows
# every worker down.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

rng = np.random.default_rng(29)


def rand_f(shape):
    return rng.integers(0, F.P_INT, size=shape, dtype=np.uint32)


def port_hash(rows):
    return tf.to_host(tp2.hash_rows(tf.from_host(rows, "cpu")))


def test_permute_matches_jax_and_host():
    states = rand_f((33, 16))
    states[0] = 0
    got = tf.to_host(tp2.permute(tf.from_host(states, "cpu")))
    assert np.array_equal(got, jf.to_host(jp2.permute(jf.from_host(states))))
    assert np.array_equal(got, hp2.permute(states))


def test_permute_leading_axes():
    states = rand_f((2, 3, 16))
    got = tf.to_host(tp2.permute(tf.from_host(states, "cpu")))
    assert np.array_equal(got, hp2.permute(states.reshape(-1, 16)).reshape(2, 3, 16))


@pytest.mark.parametrize("n,w", [(1024, 23), (1024, 2)])
def test_hash_rows_matches_pallas_interpret(n, w):
    rows = rand_f((n, w))
    pallas = jf.to_host(jp2.hash_rows_pallas(jf.from_host(rows), "interpret"))
    assert np.array_equal(port_hash(rows), pallas)


@pytest.mark.parametrize("n,w", [(6, 19), (37, 1), (1000, 7), (3, 8), (5, 0), (1, 600)])
def test_hash_rows_shapes_outside_pallas(n, w):
    """Shapes the Pallas route excludes (n not a power of two or < 1024,
    w < 2), held against the XLA lowering and the host sponge."""
    rows = rand_f((n, w))
    got = port_hash(rows)
    assert np.array_equal(got, jf.to_host(jp2._hash_rows_xla(jf.from_host(rows))))
    assert np.array_equal(got, hp2.hash_rows(rows))


def test_compress_pairs_matches_jax_and_host():
    d = rand_f((16, 8))
    got = tf.to_host(tp2.compress_pairs(tf.from_host(d, "cpu")))
    assert np.array_equal(got, jf.to_host(jp2.compress_pairs(jf.from_host(d))))
    assert np.array_equal(got, hp2.compress(d[0::2], d[1::2]))
    a, b = rand_f((5, 8)), rand_f((5, 8))
    got2 = tf.to_host(tp2.compress2(tf.from_host(a, "cpu"), tf.from_host(b, "cpu")))
    assert np.array_equal(got2, hp2.compress(a, b))


# ---------------------------------------------------------------------------
# The integer arithmetic of csrc/poseidon2.cu, step for step in numpy int64
# (every intermediate checked against the range the kernel's 32- and 64-bit
# words assume), held against the host permutation. The kernel itself runs
# only on a GPU; what it relies on is checked here.
# ---------------------------------------------------------------------------

P = F.P_INT
PINV, MU, R2 = 2164260865, 2130706431, 402124772
M32 = (1 << 32) - 1
RC_BIAS = ((hp2.RC.astype(object) << 32) % P - P).astype(np.int64)
DIAG_K = [0, 0, 0, 1, 0, 0, 1, 0, 0, 8, 3, 24, 8, 3, 4, 24]
DIAG_A = [2, 1, 2, 1, 3, 4, 1, 3, 4, 1, 1, 1, 1, 1, 1, 1]
DIAG_SIGN = [-1, 1, 1, 1, 1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1, -1]
EDGE = [0, 1, 2, P - 2, P - 1, P, P + 1, 2 * P - 1, (1 << 31) - 1, 1 << 31, M32]


def _u32(x):
    return np.asarray(x, np.int64) & M32


def _s32(x):
    x = _u32(x)
    return np.where(x >= 1 << 31, x - (1 << 32), x)


def k_smont(a, b):
    """Signed Montgomery product: |a b| < 2^31 p -> (-p, p)."""
    t = a * b
    assert np.all(np.abs(t) < (1 << 31) * P)
    r = (t >> 32) - ((_s32(_u32(t) * PINV) * P) >> 32)
    assert np.all(np.abs(r) < P)
    return r


def k_fix(w):
    assert np.all((w >= 0) & (w < 2 * P))
    return np.minimum(w, _u32(w - P))


def k_red(v):
    assert np.all((v >= 0) & (v < 124 << 31))
    r = (v >> 31) * 16777215 + (v & 0x7FFFFFFF)
    assert np.all(r < 2 * P)  # a lazy word: fits 32 bits, one k_fix from canonical
    return r


def k_to_mont(x):
    return k_smont(x, np.int64(R2)) + P


def k_from_mont(w):
    return k_fix(((_u32(w * MU) * P) >> 32) + (w != 0))


def k_sbox_rc(w, bias):
    x = k_fix(w) + bias
    return k_smont(k_smont(x, x), x)


def k_external_linear(x, offset):
    c = [offset + x[k] + x[k + 4] + x[k + 8] + x[k + 12] for k in range(4)]
    s = [None] * 16
    for j in range(0, 16, 4):
        y0, y1, y2, y3 = (c[i] + x[j + i] for i in range(4))
        assert all(np.all(y >= 0) for y in (y0, y1, y2, y3))
        t01, t23 = y0 + y1, y2 + y3
        a, b = t01 + t23 + y1, t01 + t23 + y3
        s[j : j + 4] = k_red(a + t01), k_red(a + 2 * y2), k_red(b + t23), k_red(b + 2 * y0)
    return s


def k_diag(i, s):
    """sign_i (A_i (s >> k_i) - (s mod 2^k_i) 127 2^(24 - k_i)) == diag_i s mod p."""
    k = DIAG_K[i]
    c = (127 << (24 - k)) if k else 0
    return DIAG_SIGN[i] * (DIAG_A[i] * (s >> k) - (s & ((1 << k) - 1)) * c)


def k_internal_round(s, r):
    s = list(s)
    s[0] = k_sbox_rc(s[0], RC_BIAS[r][0]) + P
    t = 9 * P + sum(s)
    return [k_red(t + k_diag(i, s[i])) for i in range(16)]


def k_coop_linear(s):
    """M_E as the 16-lanes-a-state variant takes it: M4 inside each block of
    four lanes, one fold, then 2 z + the other three blocks."""
    z = [None] * 16
    for i in range(16):
        b, k = i & 12, i & 3
        z[i] = k_red(2 * s[i] + 3 * s[b | (k + 1) & 3] + s[b | (k + 2) & 3] + s[b | (k + 3) & 3])
    return [k_red(2 * z[i] + z[i ^ 4] + z[i ^ 8] + z[i ^ 12]) for i in range(16)]


def k_permute(x, coop=False):
    """(m, 16) canonical -> canonical, as permute16 / permute_coop do it."""
    s = [k_to_mont(x[:, i].astype(np.int64)) for i in range(16)]
    lin = k_coop_linear if coop else (lambda v: k_external_linear(v, 0))
    boxed_lin = (
        (lambda v: k_coop_linear([b + P for b in v])) if coop
        else (lambda v: k_external_linear(v, 5 * P))
    )
    s = lin(s)
    for r in list(range(4)) + list(range(4, 17)) + list(range(17, 21)):
        if 4 <= r < 17:
            s = k_internal_round(s, r)
        else:
            s = boxed_lin([k_sbox_rc(s[i], RC_BIAS[r][i]) for i in range(16)])
    return np.stack([k_from_mont(w) for w in s], axis=1)


@pytest.mark.parametrize("i", range(16))
def test_diagonal_entry_is_a_shift_form(i):
    """Each internal-diagonal entry as small multiples, shifts and one
    127 * 2^(24-k) term equals the product mod p, for every 32-bit word."""
    vals = np.concatenate([np.array(EDGE, np.int64),
                           np.random.default_rng(i).integers(0, 1 << 32, 4096, dtype=np.int64)])
    want = (vals.astype(object) * int(hp2.INTERNAL_DIAG[i])) % P
    got = k_diag(i, vals)
    assert np.all(np.abs(got) <= 4 * (1 << 32))  # inside the 9p offset's reach
    assert np.all(got.astype(object) % P == want)


def test_reduction_and_montgomery_identities():
    vals = np.concatenate([np.array(EDGE, np.int64),
                           np.random.default_rng(3).integers(0, 1 << 32, 4096, dtype=np.int64)])
    wide = np.concatenate([vals, vals * 61 + 7, np.array([(124 << 31) - 1], np.int64)])
    assert np.all(k_red(wide).astype(object) % P == wide.astype(object) % P)
    canon = vals % P
    assert np.array_equal(k_from_mont(k_to_mont(canon)), canon)
    rinv = pow(1 << 32, -1, P)
    # from_mont takes any 32-bit word, not only a lazy one
    assert np.all(k_from_mont(vals).astype(object) == vals.astype(object) * rinv % P)
    a = _s32(vals) % P * np.where(vals & 1, 1, -1)  # signed operands in (-p, p)
    b = np.roll(a, 1)
    assert np.all(k_smont(a, b).astype(object) % P == a.astype(object) * b.astype(object) * rinv % P)


@pytest.mark.parametrize("coop", [False, True], ids=["thread a state", "16 lanes a state"])
def test_kernel_arithmetic_matches_host_permutation(coop):
    x = rand_f((2048, 16)).astype(np.int64)
    x[0] = 0
    x[1] = P - 1
    x[2] = 1
    x[3, ::2], x[3, 1::2] = 0, P - 1
    assert np.array_equal(k_permute(x, coop), hp2.permute(x.astype(np.uint32)).astype(np.int64))


@pytest.mark.parametrize("heights", [[], [4], [16, 2, 1]])
def test_compress_levels_plain_matches_host_merkle(heights):
    """compress_levels_plain == pair compression level by level on the host,
    with the digests of shorter matrices compressed in."""
    cur = rand_f((32, 8))
    inj = {h: rand_f((h, 8)) for h in heights}
    got = tp2.compress_levels_plain(
        tf.from_host(cur, "cpu"), {h: tf.from_host(v, "cpu") for h, v in inj.items()})
    assert [g.shape[0] for g in got] == [16, 8, 4, 2, 1]
    for g in got:
        cur = hp2.permute(cur.reshape(-1, 16))[:, :8]
        if cur.shape[0] in inj:
            cur = hp2.permute(np.concatenate([cur, inj[cur.shape[0]]], axis=1))[:, :8]
        assert np.array_equal(tf.to_host(g), cur)
