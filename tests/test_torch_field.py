"""Port field arithmetic (ziren_tpu_torch.ops.tfield) == JAX jfield == host.

Exact equality: integer field arithmetic has no tolerance. Inputs are made
with numpy from a seed and go through both packages; the JAX side runs on
the CPU in Montgomery form and is decoded before the comparison.
"""

import os

import numpy as np
import pytest
import torch

from ziren_tpu.core import ext as E
from ziren_tpu.core import field as F
from ziren_tpu.ops import jfield as jf
from ziren_tpu_torch.ops import tfield as tf

# Under pytest-xdist each worker keeps to one torch thread: the workers
# already fill the cores, and torch's thread pool on top of them slows
# every worker down.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

rng = np.random.default_rng(17)


def rand_f(shape):
    return rng.integers(0, F.P_INT, size=shape, dtype=np.uint32)


def t(x):
    return tf.from_host(x, "cpu")


def j(x):
    return jf.from_host(x)


def test_host_roundtrip():
    x = rand_f(1000)
    assert np.array_equal(tf.to_host(t(x)), x)


@pytest.mark.parametrize("op", ["madd", "msub", "mmul"])
def test_binary_ops_match_jax(op):
    a, b = rand_f(500), rand_f(500)
    a[:4] = [0, 1, F.P_INT - 1, F.P_INT - 1]
    b[:4] = [0, F.P_INT - 1, F.P_INT - 1, 1]
    jop = {"madd": jf.madd, "msub": jf.msub, "mmul": jf.mont_mul}[op]
    got = tf.to_host(getattr(tf, op)(t(a), t(b)))
    assert np.array_equal(got, jf.to_host(jop(j(a), j(b))))


def test_neg_pow_inv_match_jax():
    a = rand_f(300)
    a[0] = 0
    assert np.array_equal(tf.to_host(tf.mneg(t(a))), jf.to_host(jf.mneg(j(a))))
    assert np.array_equal(tf.to_host(tf.mpow(t(a), 12345)), jf.to_host(jf.mont_pow(j(a), 12345)))
    assert np.array_equal(tf.to_host(tf.mpow(t(a), 0)), np.ones(300, np.uint32))
    inv = tf.to_host(tf.minv(t(a)))
    assert np.array_equal(inv, jf.to_host(jf.minv(j(a))))
    assert inv[0] == 0
    assert np.array_equal(inv[1:], F.finv(a[1:]))


def test_ext_ops_match_jax():
    a, b = rand_f((40, 4)), rand_f((40, 4))
    a[0] = 0
    assert np.array_equal(tf.to_host(tf.emul(t(a), t(b))), jf.to_host(jf.emul(j(a), j(b))))
    assert np.array_equal(tf.to_host(tf.einv(t(a))), jf.to_host(jf.einv(j(a))))
    assert np.array_equal(tf.to_host(tf.einv(t(a)))[0], np.zeros(4, np.uint32))
    for k in (1, 2, 3):
        assert np.array_equal(
            tf.to_host(tf.efrobenius(t(a), k)), jf.to_host(jf.efrobenius(j(a), k))
        )
    s = rand_f(40)
    assert np.array_equal(
        tf.to_host(tf.emul_base(t(a), t(s))), jf.to_host(jf.emul_base(j(a), j(s)))
    )
    assert np.array_equal(tf.to_host(tf.efrom_base(t(s))), jf.to_host(jf.efrom_base(j(s))))
    assert np.array_equal(tf.to_host(tf.eadd(t(a), t(b))), E.eadd(a, b))
    assert np.array_equal(tf.to_host(tf.esub(t(a), t(b))), E.esub(a, b))


def test_emul_broadcasts_like_host():
    """(4,) x (n, 4) and (L, 1, 4) x (n, 4) broadcast as numpy does."""
    a, b = rand_f(4), rand_f((9, 4))
    assert np.array_equal(tf.to_host(tf.emul(t(a), t(b))), E.emul(a[None], b))
    c = rand_f((3, 1, 4))
    assert np.array_equal(tf.to_host(tf.emul(t(c), t(b))), E.emul(c, b[None]))


def test_emul_base_python_int():
    a = rand_f((7, 4))
    assert np.array_equal(tf.to_host(tf.emul_base(t(a), 12345)), E.emul_base(a, 12345))


def test_ext_inverse_is_inverse():
    a = rand_f((64, 4))
    prod = tf.to_host(tf.emul(t(a), tf.einv(t(a))))
    assert np.array_equal(prod, np.broadcast_to(E.eone(), (64, 4)))
