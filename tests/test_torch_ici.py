"""The port's intra-proof sharding (ziren_tpu_torch.stark.ici) on meshes of
CPU members, against the JAX package's stark/ici.py on the 8-device CPU
mesh of conftest.py and against the host oracle (core.merkle, core.ntt).

The inputs are those of tests/test_ici.py: seeded numpy matrices. The JAX
side takes them in Montgomery form and is decoded with jf.to_host; the port
takes and gives canonical int64. Every check is bit-exact. The port's mesh
is 8, 4 or 2 CPU members: its row blocks, the gather of subtree roots and
the exchanges of the four-step NTT run one member after the other here, and
on the card's streams in chip_smoke.py phase 12."""

import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from ziren_tpu.core import field as F
from ziren_tpu.core import merkle, ntt
from ziren_tpu.core import poseidon2 as p2
from ziren_tpu.ops import jfield as jf
from ziren_tpu.stark import ici as jici
from ziren_tpu_torch.device import Mesh
from ziren_tpu_torch.ops import tfield as tf
from ziren_tpu_torch.stark import ici

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = torch.device("cpu")
MEMBERS = (8, 4, 2)


def _inputs():
    """The matrices of tests/test_ici.py, from its seeds."""
    commit = np.random.default_rng(3).integers(0, F.P_INT, size=(256, 24), dtype=np.uint32)
    one_row = np.random.default_rng(4).integers(0, F.P_INT, size=(8, 9), dtype=np.uint32)
    leaves = np.random.default_rng(5).integers(0, F.P_INT, size=(64, 40), dtype=np.uint32)
    rng = np.random.default_rng(6)
    ntts = [rng.integers(0, F.P_INT, size=(n, w), dtype=np.uint32) for n, w in [(256, 5), (1024, 3)]]
    return commit, one_row, leaves, ntts


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's results on its 8-device mesh, decoded."""
    devs = jax.devices()
    assert len(devs) == 8, "conftest.py forces 8 virtual CPU devices"
    mesh = JaxMesh(np.array(devs), ("row",))
    commit, one_row, leaves, ntts = _inputs()
    root, digests = jici.commit_row_sharded(jf.from_host(commit), mesh)
    one_root, _ = jici.commit_row_sharded(jf.from_host(one_row), mesh)
    return {
        "root": jf.to_host(root), "digests": jf.to_host(digests),
        "one_root": jf.to_host(one_root),
        "leaves": jf.to_host(jici.leaf_hash_row_sharded(jf.from_host(leaves), mesh)),
        "ntt": [jf.to_host(jici.ntt_mesh(jf.from_host(c), mesh)) for c in ntts],
    }


def _mesh(n):
    mesh = Mesh(["cpu"] * n)
    assert [m.device for m in mesh] == [CPU] * n and len(mesh) == n
    return mesh


@pytest.mark.parametrize("members", MEMBERS)
def test_row_sharded_commit(jax_side, members):
    """Root replicated on every member and leaf digests per member, equal
    to the JAX package's mesh commit and to the host tree."""
    commit = _inputs()[0]
    roots, digests = ici.commit_row_sharded(tf.from_host(commit, CPU), _mesh(members))
    tree = merkle.commit([commit])
    assert len(roots) == len(digests) == members
    for r in roots:
        assert np.array_equal(tf.to_host(r), jax_side["root"])
        assert np.array_equal(tf.to_host(r), tree.root)
    assert [d.shape for d in digests] == [(256 // members, 8)] * members
    got = tf.to_host(torch.cat(digests))
    assert np.array_equal(got, jax_side["digests"]) and np.array_equal(got, tree.levels[0])


@pytest.mark.parametrize("members", MEMBERS)
def test_row_sharded_commit_small_blocks(jax_side, members):
    """8 rows: one row per member on the mesh of 8 (tests/test_ici.py:34),
    two and four on the smaller meshes."""
    one_row = _inputs()[1]
    roots, _ = ici.commit_row_sharded(tf.from_host(one_row, CPU), _mesh(members))
    want = merkle.commit([one_row]).root
    assert np.array_equal(jax_side["one_root"], want)
    for r in roots:
        assert np.array_equal(tf.to_host(r), want)


@pytest.mark.parametrize("members", MEMBERS)
def test_row_sharded_leaf_hashes(jax_side, members):
    leaves = _inputs()[2]
    got = ici.leaf_hash_row_sharded(tf.from_host(leaves, CPU), _mesh(members))
    assert len(got) == members
    got = tf.to_host(torch.cat(got))
    assert np.array_equal(got, jax_side["leaves"]) and np.array_equal(got, p2.hash_rows(leaves))


@pytest.mark.parametrize("members", MEMBERS)
@pytest.mark.parametrize("case", [0, 1], ids=["256x5", "1024x3"])
def test_ntt_mesh(jax_side, members, case):
    """The four-step NTT with both exchanges between members, natural
    order, equal to the JAX package's all_to_all version and to the host
    NTT."""
    coeffs = _inputs()[3][case]
    got = tf.to_host(ici.ntt_mesh(tf.from_host(coeffs, CPU), _mesh(members)))
    assert np.array_equal(got, jax_side["ntt"][case])
    assert np.array_equal(got, ntt.ntt(coeffs))


def test_the_mesh_must_fit():
    """The axis is the mesh's, the rows split evenly, and the NTT's two axes
    divide by the mesh (the JAX package's assertion)."""
    mat = tf.from_host(_inputs()[0], CPU)
    with pytest.raises(ValueError, match="axis"):
        ici.commit_row_sharded(mat, _mesh(2), axis="shard")
    with pytest.raises(ValueError, match="powers of two"):
        ici.commit_row_sharded(mat[:192], _mesh(2))
    with pytest.raises(ValueError, match="do not split"):
        ici.leaf_hash_row_sharded(mat[:9], _mesh(2))
    with pytest.raises(AssertionError, match="divide both axes"):
        ici.ntt_mesh(tf.from_host(_inputs()[3][0], CPU)[:32], _mesh(8))
