"""The Merkle levels of the port (ziren_tpu_torch.ops.tpcs.merkle_levels) ==
jpcs._merkle_levels of the JAX package, level for level, tolerance 0, and
the way the port splits a tree between one permute call a level (tall
levels) and one compress_levels call (from kernels.LEVELS_MAX_HEIGHT
digests down to the root). On the CPU both routes run the plain versions;
the kernels themselves are held against these on the GPU
(tests/test_torch_kernels.py, chip_smoke.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ziren_tpu.core import field as F
from ziren_tpu.ops import jfield as jf
from ziren_tpu.ops import jpcs
from ziren_tpu_torch import kernels
from ziren_tpu_torch.ops import tfield as tf
from ziren_tpu_torch.ops import tpcs
from ziren_tpu_torch.ops import tposeidon2 as tp2

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# (height, width) of each matrix of a tree
TREES = {
    "one matrix": [(64, 5)],
    "one row": [(1, 9)],
    "two rows": [(2, 3)],
    "shared top height": [(128, 3), (128, 6)],
    "injected heights": [(256, 4), (64, 7), (8, 2), (1, 5)],
    "every height injected": [(32, 1), (16, 2), (8, 3), (4, 4), (2, 5), (1, 6)],
}
_JAX_LEVELS: dict = {}


def mats_of(name):
    rng = np.random.default_rng(sorted(TREES).index(name))
    return [rng.integers(0, F.P_INT, hw, dtype=np.uint32) for hw in TREES[name]]


def jax_levels(name):
    if name not in _JAX_LEVELS:
        mats = [jf.mont_encode(jnp.asarray(m)) for m in mats_of(name)]
        _JAX_LEVELS[name] = [jf.to_host(lvl) for lvl in jpcs._merkle_levels(mats)]
    return _JAX_LEVELS[name]


@pytest.fixture
def calls(monkeypatch):
    """Counts the level-by-level and the fused calls merkle_levels makes."""
    seen = {"pairs": 0, "levels": []}
    pairs, levels = tp2.compress_pairs, tp2.compress_levels

    def count_pairs(x):
        seen["pairs"] += 1
        return pairs(x)

    def count_levels(cur, injected):
        seen["levels"].append((int(cur.shape[0]), sorted(injected, reverse=True)))
        return levels(cur, injected)

    monkeypatch.setattr(tp2, "compress_pairs", count_pairs)
    monkeypatch.setattr(tp2, "compress_levels", count_levels)
    return seen


@pytest.mark.parametrize("limit", [256, 16, 2, 1])
@pytest.mark.parametrize("name", sorted(TREES))
def test_levels_match_jax(monkeypatch, calls, name, limit):
    """Whatever height the fused entry starts at, the levels are those of
    the JAX package. limit 1 leaves every level to the per-level route."""
    monkeypatch.setattr(kernels, "LEVELS_MAX_HEIGHT", limit)
    got = tpcs.merkle_levels([tf.from_host(m, "cpu") for m in mats_of(name)])
    want = jax_levels(name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(tf.to_host(g), w)
    top = max(h for h, _w in TREES[name])
    fused_from = min(top, limit)
    per_level = (top // fused_from).bit_length() - 1
    assert calls["pairs"] >= per_level  # compress_levels_plain calls it too
    if fused_from > 1:
        below = sorted({h for h, _w in TREES[name] if h < fused_from}, reverse=True)
        assert calls["levels"] == [(fused_from, below)]
    else:
        assert calls["levels"] == []


def test_split_at_the_shipped_limit(monkeypatch, calls):
    """A tree of 4096 leaves with matrices at 512, 64 and 2: four levels go
    through permute one by one (4096 -> ... -> 256, the matrix at 512
    compressed in on the way), then one fused call takes 256 digests and the
    two injected heights below. The same levels come out with everything
    level by level."""
    assert kernels.LEVELS_MAX_HEIGHT == 256
    rng = np.random.default_rng(5)
    mats = [tf.from_host(rng.integers(0, F.P_INT, hw, dtype=np.uint32), "cpu")
            for hw in [(4096, 2), (512, 3), (64, 5), (2, 9)]]
    got = tpcs.merkle_levels(mats)
    assert calls["levels"] == [(256, [64, 2])]
    assert [int(l.shape[0]) for l in got] == [4096 >> i for i in range(13)]
    monkeypatch.setattr(kernels, "LEVELS_MAX_HEIGHT", 1)
    want = tpcs.merkle_levels(mats)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_split_levels_are_views_of_one_buffer():
    flat = torch.arange(7 * 8).reshape(7, 8)
    levels = kernels.split_levels(flat, 8)
    assert [tuple(l.shape) for l in levels] == [(4, 8), (2, 8), (1, 8)]
    assert torch.equal(torch.cat(levels), flat)
    assert levels[2].data_ptr() == flat[6:].data_ptr()


@pytest.mark.parametrize("m,lanes", [(1, True), (8, True), (1 << 10, True), (8192, True),
                                     (8193, False), (1 << 14, False), (1 << 16, False)])
def test_k2_variant_by_m(m, lanes):
    """Small m: 16 lanes a state; large m: one thread a state. The kernel's
    entry makes the choice, from the limit the generated header hands it."""
    assert (m <= kernels.PERMUTE_LANES_MAX_STATES) is lanes
    with open(os.path.join(kernels.CSRC, "poseidon2.cu")) as f:
        entry = f.read().split('extern "C" int zt_permute(')[1].split("}")[0]
    assert "m <= ZT_PERMUTE_LANES_MAX ? zt_permute_lanes(" in entry
    assert ": zt_permute_thread(" in entry
