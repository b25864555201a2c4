"""The hand-written CUDA kernels (ziren_tpu_torch.kernels) and their routing.

The wrapper checks and the routing run everywhere. The kernel cases, marked
`cuda`, need a CUDA device: they hold K1/K2 against the plain PyTorch
versions bit for bit and skip on a machine without one. This file imports
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
    assert resolve_device("cpu") == torch.device("cpu")


def test_constants_header_is_montgomery():
    text = kernels.constants_header()
    first = int(text.split("ZT_RC_MONT[30][16] = {\n  {")[1].split("u")[0])
    assert first == (int(hp2.RC[0, 0]) << 32) % F.P_INT
    assert "ZT_DIAG_MONT[16]" in text


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


@pytest.mark.cuda
def test_k1_rejects_bad_inputs(cuda):
    rows = tf.from_host(rand((64, 16), 1), cuda)
    with pytest.raises(ValueError):
        kernels.hash_rows(rows.int())
    with pytest.raises(ValueError):
        kernels.hash_rows(rows.t())
    with pytest.raises(ValueError):
        kernels.permute(rows[:, :8].contiguous())
