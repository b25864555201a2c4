"""The hand-written CUDA kernels (ziren_tpu_torch.kernels) and their routing.

The wrapper checks and the routing run everywhere. The kernel cases, marked
`cuda`, need a CUDA device: they hold K1, K2 (both variants), K3 (on every
cluster size) and K4 against the plain PyTorch versions bit for bit, also
when replayed from a CUDA graph, and skip on a machine without one. This file imports no JAX, so the kernel cases also run on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from ziren_tpu.core import field as F
from ziren_tpu.core import poseidon2 as hp2
from ziren_tpu_torch import kernels
from ziren_tpu_torch.device import require_cuda
from ziren_tpu.core.challenger import DuplexChallenger
from ziren_tpu_torch.ops import tchallenger as tch
from ziren_tpu_torch.ops import tfield as tf
from ziren_tpu_torch.ops import tposeidon2 as tp2
from ziren_tpu_torch.stark.backend import resolve_device


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    kernels.build()
    return torch.device("cuda")


def rand(shape, seed):
    return np.random.default_rng(seed).integers(0, F.P_INT, shape, dtype=np.uint32)


@pytest.mark.parametrize(
    "bad",
    [
        torch.zeros((4, 8), dtype=torch.int64),  # CPU tensor
        torch.zeros((4, 8), dtype=torch.int64, device="meta"),
    ],
)
def test_wrappers_reject_non_cuda(bad):
    with pytest.raises(ValueError):
        kernels.hash_rows(bad)
    with pytest.raises(ValueError):
        kernels.permute(bad)
    with pytest.raises(ValueError):
        kernels.compress_levels(bad, {})
    state = torch.zeros(16, dtype=torch.int64, device=bad.device)
    with pytest.raises(ValueError):
        kernels.grind(state, state[:3], 16)


def test_router_rejects_other_devices():
    x = torch.zeros((4, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tp2.permute(x)
    with pytest.raises(ValueError):
        tp2.hash_rows(x)


def test_no_cpu_path_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError):
        require_cuda()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(None)  # the default is the GPU, never the CPU
    assert resolve_device("cpu") == torch.device("cpu")


def test_constants_header_is_montgomery():
    """The header holds each round constant in Montgomery form minus p, in
    constant memory and again in global memory, and names the port's file."""
    text = kernels.constants_header()
    for table in ("ZT_RC_BIAS[30][16] = {\n  {", "ZT_RC_BIAS_G[30][16] = {\n  {"):
        first = int(text.split(table)[1].split(",")[0])
        assert first == (int(hp2.RC[0, 0]) << 32) % F.P_INT - F.P_INT
    assert "ziren_tpu_torch/core/poseidon2.py" in text.splitlines()[0]
    # and the two size limits, which the kernels state nowhere else
    assert f"ZT_PERMUTE_LANES_MAX = {kernels.PERMUTE_LANES_MAX_STATES};" in text
    assert f"ZT_LEVEL_MAX = {kernels.LEVELS_MAX_HEIGHT};" in text


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,w", [(1 << 12, 1), (1 << 12, 7), (1 << 12, 8), (4099, 23), (1 << 13, 83), (300, 600), (17, 0)]
)
def test_k1_matches_plain(cuda, n, w):
    rows = tf.from_host(rand((n, w), n + w), cuda)
    before = kernels.LAUNCHES["hash_rows"]
    got = kernels.hash_rows(rows)
    assert kernels.LAUNCHES["hash_rows"] == before + 1
    assert torch.equal(got, tp2.hash_rows_plain(rows))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 127, 1 << 14])
def test_k2_matches_plain_and_host(cuda, m):
    states_np = rand((m, 16), m)
    states = tf.from_host(states_np, cuda)
    got = kernels.permute(states)
    assert torch.equal(got, tp2.permute_plain(states))
    assert np.array_equal(tf.to_host(got), hp2.permute(states_np))
    for lanes in (False, True):  # both variants, whatever m would choose
        assert torch.equal(kernels.permute_variant(states, lanes), got)


@pytest.mark.cuda
@pytest.mark.parametrize("h,heights", [(2, []), (2, [1]), (64, [16, 2]), (256, []), (256, [128, 8, 1])])
def test_k3_matches_plain(cuda, h, heights):
    cur = tf.from_host(rand((h, 8), h), cuda)
    inj = {hh: tf.from_host(rand((hh, 8), hh + 1), cuda) for hh in heights}
    before = kernels.LAUNCHES["compress_levels"]
    got = kernels.compress_levels(cur, inj)
    assert kernels.LAUNCHES["compress_levels"] == before + 1
    want = tp2.compress_levels_plain(cur, inj)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# (h, injected heights, blocks): clusters that split a tree with injected
# levels above the split, on it (hh = B), just below it and at the root
K3_SPLITS = [(256, (128, 64, 8, 4, 1), 8), (64, (32, 2, 1), 2), (64, (16, 8, 4, 1), 8),
             (16, (8, 4, 2, 1), 8), (8, (4, 2, 1), 4), (4, (2, 1), 2), (32, (8, 1), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,heights,blocks", K3_SPLITS)
def test_k3_cluster_split_matches_plain(cuda, h, heights, blocks):
    """Every cluster size, with injected levels that straddle the split
    between the blocks' subtrees and block 0's cross levels."""
    cur = tf.from_host(rand((h, 8), h + blocks), cuda)
    inj = {hh: tf.from_host(rand((hh, 8), 7 * hh + blocks), cuda) for hh in heights}
    got = kernels.compress_levels_split(cur, inj, blocks)
    want = tp2.compress_levels_plain(cur, inj)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and len(got) == len(want)


def _replays(capture_fn, fill, check, times=3):
    """Capture capture_fn() in a CUDA graph, then `times` times: fill the
    static inputs anew, replay, and check the static output."""
    out = capture_fn()  # warm-up outside the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = capture_fn()
    for i in range(times):
        fill(i)
        graph.replay()
        torch.cuda.synchronize()
        check(out)


@pytest.mark.cuda
def test_k3_and_k4_in_graph_replays(cuda):
    """K3 and K4 captured in a CUDA graph and replayed three times on new
    inputs copied into the graph's buffers: each replay equals the plain
    version (K4's scratch, best witness and counter, is reset inside the
    graph, so a replay finds the smallest witness again)."""
    cur = tf.from_host(rand((256, 8), 3), cuda)
    inj = {hh: tf.from_host(rand((hh, 8), hh), cuda) for hh in (128, 64, 8, 1)}

    def fill3(i):
        cur.copy_(tf.from_host(rand((256, 8), 50 + i), cuda))
        for hh, x in inj.items():
            x.copy_(tf.from_host(rand((hh, 8), 60 + i + hh), cuda))

    def check3(levels):
        want = tp2.compress_levels_plain(cur, inj)
        assert all(torch.equal(g, w) for g, w in zip(levels, want))

    _replays(lambda: kernels.compress_levels(cur, inj), fill3, check3)

    hosts = []
    for seed in range(3):
        rng = np.random.default_rng(900 + seed)
        host = DuplexChallenger()
        host.observe_slice(rng.integers(0, F.P_INT, 8 * 3 + 4, dtype=np.uint32))
        hosts.append(host)
    tc = tch.TChallenger.from_host(hosts[0].clone(), cuda)
    state, inputs = tc.state.clone(), tc._concat_buffer().contiguous().clone()
    want = []

    def fill4(i):
        t = tch.TChallenger.from_host(hosts[i].clone(), cuda)
        state.copy_(t.state)
        inputs.copy_(t._concat_buffer())
        want.append(hosts[i].grind(12))

    def check4(w):
        assert int(w) == want[-1]
        assert torch.equal(w, tch._grind(state, inputs, 12, 4))

    _replays(lambda: kernels.grind(state, inputs, 12), fill4, check4)


@pytest.mark.cuda
def test_permute_latency_probe(cuda):
    """The latency probe runs each form's chain and reports its cycles,
    more for a longer chain."""
    for form in (0, 1, 2, 3):
        short = int(kernels.permute_latency(form, 4, cuda))
        long = int(kernels.permute_latency(form, 64, cuda))
        assert 0 < short < long


@pytest.mark.cuda
def test_k3_rejects_bad_heights(cuda):
    with pytest.raises(ValueError):
        kernels.compress_levels(tf.from_host(rand((512, 8), 1), cuda), {})
    with pytest.raises(ValueError):
        kernels.compress_levels(tf.from_host(rand((96, 8), 1), cuda), {})
    cur = tf.from_host(rand((64, 8), 1), cuda)
    with pytest.raises(ValueError):
        kernels.compress_levels(cur, {64: cur})
    with pytest.raises(ValueError):
        kernels.compress_levels(cur, {16: cur[:8]})
    with pytest.raises(ValueError):  # 64 digests cannot go to one block of 32
        kernels.compress_levels_split(cur, {}, 1)


@pytest.mark.cuda
def test_k1_rejects_bad_inputs(cuda):
    rows = tf.from_host(rand((64, 16), 1), cuda)
    with pytest.raises(ValueError):
        kernels.hash_rows(rows.int())
    with pytest.raises(ValueError):
        kernels.hash_rows(rows.t())
    with pytest.raises(ValueError):
        kernels.permute(rows[:, :8].contiguous())


# (n_in, nb_bits): every n_in the transcript can leave and the bits of every
# config (16 core and compressed, 4 dev, 2 outer_dev), and 0 (any witness)
K4_CASES = [(0, 16), (1, 4), (2, 2), (3, 16), (4, 16), (5, 4), (6, 2), (7, 16), (4, 0), (2, 11)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,bits", K4_CASES)
def test_k4_matches_plain_and_host(cuda, n_in, bits):
    """K4's witness is the plain search's, bit for bit, and the host
    challenger's; TChallenger.grind on a CUDA state goes through K4 and
    leaves the transcript where the host's check_witness does."""
    rng = np.random.default_rng(100 * n_in + bits)
    host = DuplexChallenger()
    host.observe_slice(rng.integers(0, F.P_INT, 8 * 3 + n_in, dtype=np.uint32))
    tc = tch.TChallenger.from_host(host.clone(), cuda)
    assert tc._buf_n == n_in
    state, inputs = tc.state, tc._concat_buffer().contiguous()
    before = kernels.LAUNCHES["grind"]
    got = kernels.grind(state, inputs, bits)
    assert kernels.LAUNCHES["grind"] == before + 1 and got.dim() == 0 and got.is_cuda
    assert torch.equal(got, tch._grind(state, inputs, bits, n_in))
    want = host.grind(bits)
    assert int(got) == want
    w = tc.grind(bits)
    assert w.is_cuda and int(w) == want and kernels.LAUNCHES["grind"] == before + 2
    assert int(tc.sample()) == host.sample()


@pytest.mark.cuda
def test_k4_rejects_bad_inputs(cuda):
    state = tf.from_host(rand(16, 1), cuda)
    with pytest.raises(ValueError):
        kernels.grind(state, state[:8].contiguous(), 4)  # n_in must be below 8
    with pytest.raises(ValueError):
        kernels.grind(state, state[:2].contiguous(), 32)
    with pytest.raises(ValueError):
        kernels.grind(state[:8].contiguous(), state[:2].contiguous(), 4)
    with pytest.raises(ValueError):
        kernels.grind(state.int(), state[:2].int(), 4)


def test_launch_counts_hold_under_threads():
    """The recursion tree proves its lifts in a thread pool, so several
    threads count launches at once: no update is lost."""
    import sys
    import threading

    threads, each = 16, 2000
    saved = sys.getswitchinterval()
    before = dict(kernels.LAUNCHES), {k: dict(v) for k, v in kernels.SHAPES.items()}
    kernels.reset_launches()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(each):
                kernels._count("permute", j % 3)
                kernels._count("hash_rows", (i, 8))

        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
        assert kernels.LAUNCHES == {"hash_rows": threads * each, "permute": threads * each,
                                    "compress_levels": 0, "grind": 0}
        assert sum(kernels.SHAPES["permute"].values()) == threads * each
        assert kernels.SHAPES["hash_rows"] == {(i, 8): each for i in range(threads)}
    finally:
        sys.setswitchinterval(saved)
        kernels.reset_launches()
        kernels.LAUNCHES.update(before[0])
        for k, v in before[1].items():
            kernels.SHAPES[k].update(v)
