"""Port challenger (ziren_tpu_torch.ops.tchallenger) == JAX JChallenger ==
host DuplexChallenger, bit for bit, including the proof-of-work grind."""

import os

import jax
import numpy as np
import pytest
import torch

from ziren_tpu.core.challenger import DuplexChallenger
from ziren_tpu.ops import jfield as jf
from ziren_tpu.ops.jchallenger import JChallenger
from ziren_tpu_torch.ops import tfield as tf
from ziren_tpu_torch.ops.tchallenger import TChallenger

# Under pytest-xdist each worker keeps to one torch thread: the workers
# already fill the cores, and torch's thread pool on top of them slows
# every worker down.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

P = 2130706433


def _jcanon(x):
    return int(jax.device_get(jf.mont_decode(x)))


def test_transcript_matches_jax_and_host():
    rng = np.random.default_rng(31)
    h = DuplexChallenger()
    h.observe_slice(rng.integers(0, P, size=5, dtype=np.uint32))
    jc = JChallenger.from_host(h.clone())
    tc = TChallenger.from_host(h.clone(), "cpu")

    # interleaved observes and samples, crossing duplex boundaries
    vals = rng.integers(0, P, size=23, dtype=np.uint32)
    h.observe_slice(vals)
    jc.observe_host_slice(vals)
    tc.observe_host_slice(vals)
    for _ in range(3):
        want = h.sample()
        assert _jcanon(jc.sample_mont()) == want
        assert int(tc.sample()) == want
    more = rng.integers(0, P, size=9, dtype=np.uint32)
    h.observe_slice(more)
    jc.observe_mont_vec(jf.from_host(more))
    tc.observe_vec(tf.from_host(more, "cpu"))
    want = h.sample_ext()
    assert np.array_equal(jf.to_host(jc.sample_ext_mont()), want)
    assert np.array_equal(tf.to_host(tc.sample_ext()), want)
    # sample_ext straight out of a full output buffer (the reversed slice)
    scal = int(rng.integers(0, P))
    h.observe(scal)
    tc.observe(torch.tensor(scal))
    h.sample()
    tc.sample()
    assert np.array_equal(tf.to_host(tc.sample_ext()), h.sample_ext())
    assert int(tc.sample_bits(19)) == h.sample_bits(19)
    assert np.array_equal(tf.to_host(tc.state), h.state)


def test_from_host_with_pending_output():
    """A host challenger with a partly consumed output buffer carries over."""
    h = DuplexChallenger()
    h.observe_slice(np.arange(8, dtype=np.uint32))  # duplexes
    h.sample()
    tc = TChallenger.from_host(h.clone(), "cpu")
    assert tc._out_len == len(h.output_buffer) == 7
    for _ in range(9):
        assert int(tc.sample()) == h.sample()


@pytest.mark.parametrize("n_obs,bits", [(11, 8), (7, 6), (0, 5)])
def test_grind_matches_jax_and_host(n_obs, bits):
    rng = np.random.default_rng(4 + n_obs)
    h = DuplexChallenger()
    h.observe_slice(rng.integers(0, P, size=n_obs, dtype=np.uint32))
    jc = JChallenger.from_host(h.clone())
    tc = TChallenger.from_host(h.clone(), "cpu")
    hw = h.grind(bits)
    assert int(jax.device_get(jc.grind(bits))) == hw
    assert tc.grind(bits) == hw
    # the transcripts stay aligned after the grind replay
    assert int(tc.sample()) == h.sample()


def test_grind_is_minimal_across_batches():
    """The witness is the smallest one, also when it lies past the first
    candidate batch (batches of 8 here)."""
    from ziren_tpu_torch.ops import tchallenger as tch

    h = DuplexChallenger()
    h.observe_slice(np.arange(3, dtype=np.uint32))
    probe = h.clone()
    tc = TChallenger.from_host(h.clone(), "cpu")
    w = tch._grind(tc.state, tc._concat_buffer(), 9, tc._buf_n, batch=8)
    assert w == h.grind(9)
    assert w >= 8  # found in a later batch
    for cand in range(w):
        assert not probe.clone().check_witness(9, cand)
    assert probe.clone().check_witness(9, w)
