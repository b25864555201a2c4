"""The launch plans of K3 and K4 (ziren_tpu_torch/ops/kplans.py), executed
with the plain permutation on the CPU: equal, bit for bit (tolerance 0), to
the plain versions, to the host Merkle tree and challenger, and to the JAX
package's `jpcs._merkle_levels` and `jchallenger._grind`. The kernels run the
same plans on the card (tests/test_torch_kernels.py, chip_smoke.py):

    python -m pytest -q tests/test_torch_kernel_plans.py
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K3_ALL_SHAPES
from ziren_tpu.core import field as F
from ziren_tpu.core import merkle as hmerkle
from ziren_tpu.core import poseidon2 as hp2
from ziren_tpu.core.challenger import DuplexChallenger
from ziren_tpu.ops import jfield as jf
from ziren_tpu.ops import jpcs
from ziren_tpu.ops.jchallenger import JChallenger
from ziren_tpu_torch import kernels
from ziren_tpu_torch.ops import kplans
from ziren_tpu_torch.ops import tchallenger as tch
from ziren_tpu_torch.ops import tfield as tf
from ziren_tpu_torch.ops import tpcs
from ziren_tpu_torch.ops import tposeidon2 as tp2

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


# (h, injected heights, blocks): the shapes the paths launch K3 with, on
# their own cluster size; then small trees on every cluster that splits them,
# with injected levels above the split, on it (hh = B), just below it
# (hh = B/2) and at the root (hh = 1).
def _small_cases():
    cases = []
    for h in (2, 4, 8, 16):
        for B in (1, 2, 4, 8):
            if 2 * B > h:
                continue
            above = [hh for hh in (h // 2, h // 4) if hh >= B and hh >= 1]
            for heights in ([], sorted({B, max(B // 2, 1), 1} - {h}), above + [1]):
                heights = sorted({hh for hh in heights if 1 <= hh < h}, reverse=True)
                cases.append((h, tuple(heights), B))
    return list(dict.fromkeys(cases))


K3_CASES = [(h, heights, None) for h, heights in K3_ALL_SHAPES] + _small_cases()


def _host_levels(mats):
    return hmerkle.commit(mats).levels[1:]


@pytest.mark.parametrize("h,heights,blocks", K3_CASES)
def test_k3_plan_matches_plain_and_host(h, heights, blocks):
    """Each block's subtree and the cross levels, written at the plan's rows,
    are the levels of compress_levels_plain and of the host Merkle tree of
    the same matrices (leaves of the tallest, the shorter ones injected)."""
    rng = np.random.default_rng(h * 1000 + sum(heights) + (blocks or 0))
    mats = [rng.integers(0, F.P_INT, (h, 3), dtype=np.uint32)]
    mats += [rng.integers(0, F.P_INT, (hh, 2), dtype=np.uint32) for hh in heights]
    digests = tf.from_host(hp2.hash_rows(mats[0]), "cpu")
    injected = {m.shape[0]: tf.from_host(hp2.hash_rows(m), "cpu") for m in mats[1:]}
    plan = kplans.k3_plan(h, heights, blocks)
    flat = kplans.run_k3_plan(plan, digests, injected)
    got = kernels.split_levels(flat, h)
    want = tp2.compress_levels_plain(digests, injected)
    host = _host_levels(mats)
    assert len(got) == len(want) == len(host) == h.bit_length() - 1
    for g, w, ho in zip(got, want, host):
        assert torch.equal(g, w)
        assert np.array_equal(tf.to_host(g), ho)


# Trees whose tallest matrix hands `limit` digests to K3, with shorter
# chips' matrices injected above and below the cluster's split.
JAX_TREES = {
    "traces": [(512, 2), (256, 3), (64, 1), (8, 2), (1, 1)],
    "every height": [(512, 1), (256, 1), (128, 2), (32, 1), (16, 2), (4, 1), (2, 1)],
    "one matrix": [(512, 3)],
}
_JAX_LEVELS: dict = {}


def _jax_mats(name):
    rng = np.random.default_rng(sorted(JAX_TREES).index(name) + 40)
    return [rng.integers(0, F.P_INT, hw, dtype=np.uint32) for hw in JAX_TREES[name]]


@pytest.mark.parametrize("limit,blocks", [(256, None), (64, 2), (64, 8), (16, 8)])
@pytest.mark.parametrize("name", sorted(JAX_TREES))
def test_k3_plan_matches_jax(monkeypatch, name, limit, blocks):
    """tpcs.merkle_levels with its K3 call taken by the plan's executor, on
    bit-reversed matrices as the prover hands them over: the levels of the
    JAX package's jpcs._merkle_levels, level for level."""
    mats = _jax_mats(name)
    if name not in _JAX_LEVELS:
        jm = [jf.mont_encode(jnp.asarray(m)) for m in mats]
        _JAX_LEVELS[name] = [jf.to_host(lvl) for lvl in jpcs._merkle_levels(jm)]
    seen = []

    def by_plan(cur, injected):
        h = int(cur.shape[0])
        plan = kplans.k3_plan(h, injected, blocks)
        seen.append((h, plan.blocks))
        return kernels.split_levels(kplans.run_k3_plan(plan, cur, injected), h)

    monkeypatch.setattr(kernels, "LEVELS_MAX_HEIGHT", limit)
    monkeypatch.setattr(tp2, "compress_levels", by_plan)
    got = tpcs.merkle_levels([tf.from_host(m, "cpu") for m in mats])
    want = _JAX_LEVELS[name]
    assert seen == [(limit, blocks or kplans.k3_blocks(limit))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(tf.to_host(g), w)


@pytest.mark.parametrize("h", [1 << k for k in range(1, 9)])
def test_k3_plan_layout(h):
    """Every cluster that splits h digests: the blocks' digests and their
    rows of each injected level partition them; the levels' rows tile the
    (h - 1, 8) output; the blocks' levels end at height B and the cross
    levels take the rest; the default is one block up to 16 digests and
    the widest cluster above; other splits are refused."""
    heights = [hh for hh in (1 << k for k in range(8)) if hh < h]
    default = kplans.k3_blocks(h)
    assert default == (1 if h <= kplans.K3_ONE_BLOCK_MAX else min(8, h // 2))
    assert 2 * default <= h and h // default <= kplans.K3_BLOCK_DIGESTS_MAX
    for B in (1, 2, 4, 8, 16):
        if B > 8 or 2 * B > h or h // B > kplans.K3_BLOCK_DIGESTS_MAX:
            with pytest.raises(ValueError):
                kplans.k3_plan(h, heights, B)
            continue
        plan = kplans.k3_plan(h, heights, B)
        assert plan.blocks == B and plan.sub * B == h
        rows = sorted(off + i for _hh, off in plan.block_levels + plan.cross_levels
                      for i in range(_hh))
        assert rows == list(range(h - 1))
        assert [hh for hh, _ in plan.block_levels] == [h >> k for k in range(1, (h // B).bit_length())]
        assert [hh for hh, _ in plan.cross_levels] == [B >> k for k in range(1, B.bit_length())]
        assert set(plan.rows) | set(plan.cross_injected) == set(heights)
        for hh, spans in plan.rows.items():
            assert hh >= B and len(spans) == B
            assert [lo for lo, _ in spans] == [b * hh // B for b in range(B)]
            assert spans[-1][1] == hh and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(hh < B for hh in plan.cross_injected)
    for bad_h in (0, 1, 3, 96, 512):
        with pytest.raises(ValueError):
            kplans.k3_plan(bad_h, [])
    with pytest.raises(ValueError):
        kplans.k3_plan(64, [64])
    with pytest.raises(ValueError):
        kplans.k3_plan(64, [3])


K4_ORDERS = 16
_K4_REF: dict = {}


def _k4_reference(n_in, bits):
    """(state, inputs, host witness, JAX witness, hit) for one transcript."""
    key = (n_in, bits)
    if key not in _K4_REF:
        rng = np.random.default_rng(100 * n_in + bits)
        host = DuplexChallenger()
        host.observe_slice(rng.integers(0, F.P_INT, 8 * 3 + n_in, dtype=np.uint32))
        tc = tch.TChallenger.from_host(host.clone(), "cpu")
        assert tc._buf_n == n_in
        state, inputs = tc.state, tc._concat_buffer()
        jw = int(jax.device_get(JChallenger.from_host(host.clone()).grind(bits)))
        hits = kplans.grind_hits(state, inputs, bits, 1 << 13)

        def hit(w):
            assert w < hits.size, "the search ran past the candidates computed"
            return bool(hits[w])

        _K4_REF[key] = (state, inputs, host.grind(bits), jw, hit)
    return _K4_REF[key]


@pytest.mark.parametrize("order", range(K4_ORDERS))
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n_in", range(8))
def test_k4_plan_finds_the_smallest_witness(n_in, bits, order):
    """K4's plan with its warps' claims, reads, tests and atomicMins taken
    in a seeded order, out of order across warps and lanes (at 2 and 4 bits
    the grid-stride form's threads, and the ordered search beside it): the
    witness is the host challenger's, the JAX package's _grind's and the
    plain search's, and every candidate below it was tested."""
    state, inputs, want, jw, hit = _k4_reference(n_in, bits)
    # one block (128 candidates by position, the rest claimed) or two; at 2
    # and 4 bits the plan's grid-stride form, and the ordered search too
    plan = kplans.k4_plan(bits, occupancy=(1 if order < K4_ORDERS // 2 else 3, 1))
    if not plan.ordered:
        ordered = kplans.K4Plan(1, plan.threads, plan.chunk, plan.scratch)
        best, tested = kplans.run_k4_plan(ordered, hit, order_seed=order + 7)
        assert best == want and set(range(best)) <= tested
    best, tested = kplans.run_k4_plan(plan, hit, order_seed=1000 * n_in + 10 * bits + order)
    assert best == want == jw
    assert set(range(best)) <= tested
    if order == 0:
        assert int(tch._grind(state, inputs, bits, n_in)) == want


@pytest.mark.parametrize("bits", [0, 2, 4, 8, 11, 16, 20, 31])
@pytest.mark.parametrize("per_sm,sms", [(1, 1), (3, 1), (1, 132), (7, 132), (8, 132)])
def test_k4_plan_grid(bits, per_sm, sms):
    """The grid is K4_BLOCKS_PER_SM blocks a multiprocessor (all that fit,
    if fewer), all resident at once, or fewer where twice the expected
    witness needs fewer; up to K4_STRIDE_MAX_BITS the form is the
    grid-stride one; a warp claims one candidate a lane; the scratch is the
    best witness and the counter, each on a cache line of its own."""
    plan = kplans.k4_plan(bits, (per_sm, sms))
    want = -(-(2 << bits) // plan.threads)
    assert plan.ordered == (bits > kplans.K4_STRIDE_MAX_BITS)
    per_sm_used = min(per_sm, kplans.K4_BLOCKS_PER_SM) if plan.ordered else per_sm
    assert plan.grid == min(sms * per_sm_used, want) >= 1
    assert plan.grid <= sms * per_sm
    assert plan.threads % 32 == 0 and plan.chunk % 32 == 0 and plan.chunk >= 32
    assert plan.scratch * 8 >= 256 and 1 <= kplans.K4_COUNTER and kplans.K4_COUNTER * 8 % 128 == 0
    for bad in ((0, sms), (per_sm, 0)):
        with pytest.raises(ValueError):
            kplans.k4_plan(bits, bad)
    with pytest.raises(ValueError):
        kplans.k4_plan(32, (per_sm, sms))
