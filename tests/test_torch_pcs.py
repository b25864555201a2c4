"""Port PCS pieces (ziren_tpu_torch.ops.tpcs) == JAX jpcs == host PCS, bit
for bit: coset LDE, batched Merkle commit (root and every level), domain
restriction, contractions, power tables, FRI fold and query gathers."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ziren_tpu.core import ext as E
from ziren_tpu.core import field as F
from ziren_tpu.core import merkle, ntt
from ziren_tpu.ops import jfield as jf
from ziren_tpu.ops import jpcs
from ziren_tpu.stark import pcs
from ziren_tpu.stark.domain import Domain, natural_domain_for_degree
from ziren_tpu_torch.ops import tfield as tf
from ziren_tpu_torch.ops import tpcs

# Under pytest-xdist each worker keeps to one torch thread: the workers
# already fill the cores, and torch's thread pool on top of them slows
# every worker down.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

rng = np.random.default_rng(41)


def rand_f(shape):
    return rng.integers(0, F.P_INT, size=shape, dtype=np.uint32)


def t(x):
    return tf.from_host(x, "cpu")


def j(x):
    return jf.mont_encode(jnp.asarray(np.ascontiguousarray(x)))


def h(x):
    return tf.to_host(x)


@pytest.fixture(scope="module")
def batch():
    """One mixed batch committed by both packages: three heights, and a
    matrix sharing the tallest height on another coset shift (as quotient
    chunks do)."""
    mats = [rand_f(hw) for hw in [(64, 5), (64, 3), (32, 7), (16, 11)]]
    doms = [natural_domain_for_degree(m.shape[0]) for m in mats]
    doms[1] = Domain(6, (F.GENERATOR * 5) % F.P_INT)
    jroot, jdata = jpcs.commit([(d, j(m)) for d, m in zip(doms, mats)], 1)
    troot, tdata = tpcs.commit([(d, t(m)) for d, m in zip(doms, mats)], 1)
    return mats, doms, (jroot, jdata), (troot, tdata)


def test_commit_matches_jax(batch):
    mats, _doms, (jroot, jdata), (troot, tdata) = batch
    assert np.array_equal(h(troot), jpcs.ext_from_mont_host(jroot))
    assert len(tdata.tree.levels) == len(jdata.tree.levels)
    for tl, jl in zip(tdata.tree.levels, jdata.tree.levels):
        assert np.array_equal(h(tl), jpcs.ext_from_mont_host(jl))
    for i in range(len(mats)):
        assert np.array_equal(h(tdata.lde(i)), jpcs.ext_from_mont_host(jdata.lde(i)))
        assert np.array_equal(h(tdata.coeff(i)), jpcs.ext_from_mont_host(jdata.coeff(i)))
    assert tdata.tree.layout() == jdata.tree.layout()


def test_commit_matches_host():
    """Natural-domain batch against the host interpolate -> coset LDE ->
    bit-reverse -> Merkle commit."""
    mats = [rand_f((32, 4)), rand_f((32, 2)), rand_f((8, 3))]
    doms = [natural_domain_for_degree(m.shape[0]) for m in mats]
    host_brs = []
    for m in mats:
        lde = ntt.coset_eval(ntt.intt(m), 1, F.GENERATOR)
        host_brs.append(lde[F.bit_reverse_indices(int(m.shape[0]).bit_length())])
    host_tree = merkle.commit(host_brs)
    root, data = tpcs.commit([(d, t(m)) for d, m in zip(doms, mats)], 1)
    assert np.array_equal(h(root), host_tree.root)
    for tl, hl in zip(data.tree.levels, host_tree.levels):
        assert np.array_equal(h(tl), hl)


def test_evals_on_domain(batch):
    mats, doms, (_jr, jdata), (_tr, tdata) = batch
    for i in (0, 2):
        for size in (2 * doms[i].size, doms[i].size):
            qdom = doms[i].create_disjoint_domain(size)
            got = h(tpcs.evals_on_domain(tdata, i, qdom))
            want = jpcs.ext_from_mont_host(jpcs.evals_on_domain(jdata, i, qdom))
            assert np.array_equal(got, want)
    host = ntt.coset_eval(ntt.intt(mats[0]), 1, F.GENERATOR)
    qdom = doms[0].create_disjoint_domain(128)
    assert np.array_equal(h(tpcs.evals_on_domain(tdata, 0, qdom)), host)


def test_contractions_match_jax():
    mat, vec, zp = rand_f((64, 21)), rand_f((21, 4)), rand_f((64, 4))
    got = h(tpcs.mat_ext_matmul(t(mat), t(vec)))
    assert np.array_equal(got, jf.to_host(jpcs.mat_ext_matmul(j(mat), j(vec))))
    got = h(tpcs.colwise_ext_contract(t(mat), t(zp)))
    assert np.array_equal(got, jf.to_host(jpcs.colwise_ext_contract(j(mat), j(zp))))


@pytest.mark.parametrize("n,w", [(32, 0), (8, 100), (1, 3)])
def test_contractions_match_host(n, w):
    mat, vec, zp = rand_f((n, w)), rand_f((w, 4)), rand_f((n, 4))
    got = h(tpcs.mat_ext_matmul(t(mat), t(vec)))
    assert np.array_equal(got, pcs._mod_matmul_base_ext(mat, vec))
    got = h(tpcs.colwise_ext_contract(t(mat), t(zp)))
    want = pcs._mod_matmul_base_ext(mat.T.copy(), zp) if n else np.zeros((w, 4), np.uint32)
    assert np.array_equal(got, want)


def test_power_tables_match_jax_and_host():
    z = rand_f(4)
    assert np.array_equal(h(tpcs.zpow_table(t(z), 6)), jf.to_host(jpcs.zpow_table(j(z), log_n=6)))
    for n in (0, 1, 5, 64, 77):
        got = h(tpcs.epowers_rev(t(z), n))
        assert np.array_equal(got, E.epowers(z, n)[::-1].reshape(n, 4))
        if n == 77:
            assert np.array_equal(got, jf.to_host(jpcs.epowers_rev_dev(j(z), n)))
    dom = natural_domain_for_degree(64)
    assert np.array_equal(h(tpcs.next_point(t(z), dom)), dom.next_point(z))


@pytest.mark.parametrize("log_h,shift", [(6, F.GENERATOR), (3, pow(F.GENERATOR, 4, F.P_INT))])
def test_fri_fold_matches_jax(log_h, shift):
    e = rand_f((1 << log_h, 4))
    beta = rand_f(4)
    got = h(tpcs.fri_fold(t(e), t(beta), log_h, shift))
    want = jf.to_host(jpcs.fri_fold(j(e), j(beta), log_h=log_h, shift=shift))
    assert np.array_equal(got, want)


def test_gather_matches_jax_and_host(batch):
    _mats, _doms, (_jr, jdata), (_tr, tdata) = batch
    idxs = rng.integers(0, 128, size=7)
    rows, paths = tpcs.gather_tree_openings(tdata.tree, t(idxs), 7)
    jrows, jpaths = jpcs.gather_tree_openings(jdata.tree, jnp.asarray(idxs, jnp.int32), 7)
    assert np.array_equal(h(paths), jf.to_host(jpaths))
    for r, jr in zip(rows, jrows):
        assert np.array_equal(h(r), jf.to_host(jr))
    # host Merkle opening of the same tree: rows in batch order, then path
    host_tree = merkle.commit([h(m) for m in tdata.tree.mats_br])
    for q, i in enumerate(idxs):
        hrows, hpath = merkle.open_at(host_tree, int(i))
        assert np.array_equal(h(paths[q]), np.asarray(hpath))
        assert np.array_equal(np.concatenate([h(r[q]) for r in rows[:2]]), hrows[0])
