"""ziren_tpu_torch.ops.tmerkle == ziren_tpu.ops.jmerkle and the host tree
(core/merkle.py), and ziren_tpu_torch.ops.tntt == ziren_tpu.ops.jntt and the
host NTT (core/ntt.py), tolerance 0: these are field elements. On the CPU
the JAX functions run through their XLA lowering (the Pallas sponge is
routed to only on an accelerator) and the port through the plain versions
of its kernels; the kernels themselves are held against those on the GPU
(chip_smoke.py)."""

import os

import numpy as np
import pytest
import torch

from ziren_tpu.core import field as F
from ziren_tpu.core import merkle as hmerkle
from ziren_tpu.core import ntt as hntt
from ziren_tpu.ops import jfield as jf
from ziren_tpu.ops import jmerkle, jntt
from ziren_tpu_torch import kernels
from ziren_tpu_torch.core import merkle as port_hmerkle
from ziren_tpu_torch.core import ntt as port_hntt
from ziren_tpu_torch.ops import tfield as tf
from ziren_tpu_torch.ops import tmerkle, tntt
from ziren_tpu_torch.ops import tposeidon2 as tp2

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _mat(n, w, seed):
    return np.random.default_rng(seed).integers(0, F.P_INT, (n, w), dtype=np.uint32)


@pytest.mark.parametrize("n,w", [(1024, 32), (1024, 13), (512, 1), (4, 83), (1, 9)])
def test_leaf_hashes_and_root_match_jax_and_host(n, w):
    m = _mat(n, w, n + w)
    jm = jf.from_host(m)
    leaves = tf.to_host(tmerkle.leaf_hashes(tf.from_host(m, "cpu")))
    root = tf.to_host(tmerkle.merkle_root(tf.from_host(m, "cpu")))
    assert np.array_equal(leaves, jf.to_host(jmerkle.leaf_hashes(jm)))
    assert np.array_equal(root, jf.to_host(jmerkle.merkle_root(jm)))
    for host in (hmerkle, port_hmerkle):
        tree = host.commit([m])
        assert np.array_equal(leaves, tree.levels[0])
        assert np.array_equal(root, tree.root)


@pytest.mark.parametrize("n,levels", [(1024, 10), (1024, 3), (1024, 0), (256, 8), (64, 5), (2, 1)])
def test_compress_levels_matches_jax(n, levels):
    d = _mat(n, 8, 7 * n + levels)
    got = tf.to_host(tmerkle.compress_levels(tf.from_host(d, "cpu"), levels))
    want = jf.to_host(jmerkle.compress_levels(jf.from_host(d), levels))
    assert got.shape == (n >> levels, 8)
    assert np.array_equal(got, want)


def test_compress_levels_route(monkeypatch):
    """A fold to the root hands kernels.LEVELS_MAX_HEIGHT digests to the one
    fused call; a fold that stops above the root never takes it."""
    seen = []
    fused = tp2.compress_levels
    monkeypatch.setattr(tp2, "compress_levels",
                        lambda cur, inj: seen.append((int(cur.shape[0]), dict(inj))) or fused(cur, inj))
    d = tf.from_host(_mat(1024, 8, 1), "cpu")
    tmerkle.compress_levels(d, 10)
    assert seen == [(kernels.LEVELS_MAX_HEIGHT, {})]
    seen.clear()
    tmerkle.compress_levels(d, 9)
    tmerkle.compress_levels(d[:64], 2)
    assert seen == []


@pytest.mark.parametrize("n,w", [(64, 3), (32, 2), (1024, 5), (2, 1)])
def test_ntt_and_intt_match_jax_and_host(n, w):
    m = _mat(n, w, 3 * n + w)
    got = tntt.ntt(m, device="cpu")
    assert got.dtype == np.uint32
    assert np.array_equal(got, jntt.ntt_device(m))
    assert np.array_equal(got, hntt.ntt(m)) and np.array_equal(got, port_hntt.ntt(m))
    back = tntt.intt(got, device="cpu")
    assert np.array_equal(back, jntt.intt_device(got))
    assert np.array_equal(back, m)


@pytest.mark.parametrize("n,w,added,shift", [(16, 2, 1, F.GENERATOR), (64, 3, 2, F.GENERATOR),
                                             (8, 1, 1, 1), (256, 4, 1, 5)])
def test_coset_lde_matches_jax_and_host(n, w, added, shift):
    m = _mat(n, w, n + added)
    got = tntt.coset_lde(m, added, shift, device="cpu")
    assert got.shape == (n << added, w)
    assert np.array_equal(got, jntt.coset_lde_device(m, added, shift))
    assert np.array_equal(got, hntt.coset_lde(m, added, shift))
    assert np.array_equal(got, port_hntt.coset_lde(m, added, shift))


def test_ntt_without_a_device_needs_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    m = _mat(8, 1, 0)
    for call in (lambda: tntt.ntt(m), lambda: tntt.intt(m), lambda: tntt.coset_lde(m, 1, 3)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
