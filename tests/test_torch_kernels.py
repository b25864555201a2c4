"""The hand-written CUDA kernels (ziren_tpu_torch.kernels) and their routing.

The wrapper checks and the routing run everywhere. The kernel cases, marked
`cuda`, need a CUDA device: they hold K1, K2 (both variants) and K3 against
the plain PyTorch versions bit for bit and skip on a machine without one. This file imports
no JAX, so the kernel cases also run on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from ziren_tpu.core import field as F
from ziren_tpu.core import poseidon2 as hp2
from ziren_tpu_torch import kernels
from ziren_tpu_torch.device import require_cuda
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


@pytest.mark.cuda
def test_k1_rejects_bad_inputs(cuda):
    rows = tf.from_host(rand((64, 16), 1), cuda)
    with pytest.raises(ValueError):
        kernels.hash_rows(rows.int())
    with pytest.raises(ValueError):
        kernels.hash_rows(rows.t())
    with pytest.raises(ValueError):
        kernels.permute(rows[:, :8].contiguous())


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
                                    "compress_levels": 0}
        assert sum(kernels.SHAPES["permute"].values()) == threads * each
        assert kernels.SHAPES["hash_rows"] == {(i, 8): each for i in range(threads)}
    finally:
        sys.setswitchinterval(saved)
        kernels.reset_launches()
        kernels.LAUNCHES.update(before[0])
        for k, v in before[1].items():
            kernels.SHAPES[k].update(v)
