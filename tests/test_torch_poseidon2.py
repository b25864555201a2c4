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
