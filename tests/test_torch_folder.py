"""Port folders (ziren_tpu_torch.stark.tfolder) == JAX jfolder == host folders.

The LogUp permutation trace (batched fingerprints, one inverse, cumsum)
and the quotient fold are held against the JAX device bodies, run eagerly
on the CPU, on the engine's test AIRs; and against the host numpy folders
on chips of the MIPS machine with a real fibonacci trace. Exact equality.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_stark_engine import FibonacciAir, SenderAir, TableAir

from ziren_tpu.core import ext as E
from ziren_tpu.core import field as F
from ziren_tpu.ops import jfield as jf
from ziren_tpu.stark import jfolder
from ziren_tpu.stark.config import dev_config
from ziren_tpu.stark.domain import natural_domain_for_degree
from ziren_tpu.stark.folder import QuotientFolder, TraceFolder
from ziren_tpu.stark.machine import StarkMachine
from ziren_tpu.stark.permutation import generate_permutation_trace
from ziren_tpu_torch.ops import tfield as tf
from ziren_tpu_torch.stark import tfolder

# Under pytest-xdist each worker keeps to one torch thread: the workers
# already fill the cores, and torch's thread pool on top of them slows
# every worker down.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

rng = np.random.default_rng(53)


def rand_f(shape):
    return rng.integers(0, F.P_INT, size=shape, dtype=np.uint32)


def t(x):
    return tf.from_host(x, "cpu")


def j(x):
    return jf.from_host(np.asarray(x, np.uint32))


def h(x):
    return tf.to_host(x)


def _sels_host(tdom, qdom):
    return tdom.selectors_on_coset(qdom)


def test_selectors_match_jax_and_host():
    tdom = natural_domain_for_degree(32)
    qdom = tdom.create_disjoint_domain(64)
    got = tfolder.selectors_on_coset(tdom.log_n, tdom.shift, qdom.log_n, qdom.shift, "cpu")
    jsel = jfolder.selectors_on_coset_device(tdom.log_n, tdom.shift, qdom.log_n, qdom.shift)
    host = _sels_host(tdom, qdom)
    for k in ("is_first_row", "is_last_row", "is_transition", "inv_zeroifier"):
        assert np.array_equal(h(got[k]), jf.to_host(jsel[k])), k
        assert np.array_equal(h(got[k]), host[k]), k


def test_perm_trace_matches_jax():
    machine = StarkMachine(dev_config(), [SenderAir(), TableAir()])
    n = 64
    alpha, beta = rand_f(4), rand_f(4)
    for chip, w in zip(machine.chips, (1, 2)):
        main = rand_f((n, w))
        got, cum = tfolder.perm_trace(chip, t(main), None, [], t(alpha), t(beta))
        jgot, jcum = jfolder._perm_body(
            chip, j(main), None, jnp.zeros((0,), jnp.uint32), j(alpha), j(beta)
        )
        assert np.array_equal(h(got), jf.to_host(jgot))
        assert np.array_equal(h(cum), jf.to_host(jcum))


def test_perm_trace_without_lookups():
    machine = StarkMachine(dev_config(), [FibonacciAir()], num_public_values=3)
    got, cum = tfolder.perm_trace(
        machine.chips[0], t(rand_f((16, 2))), None, [0, 1, 2], t(rand_f(4)), t(rand_f(4))
    )
    assert got.shape == (16, 0) and np.array_equal(h(cum), np.zeros(4, np.uint32))


@pytest.mark.parametrize("air,width", [(FibonacciAir(), 2), (TableAir(), 2)])
def test_quotient_matches_jax(air, width):
    npv = 3 if isinstance(air, FibonacciAir) else 0
    chip = StarkMachine(dev_config(), [air], num_public_values=npv).chips[0]
    tdom = natural_domain_for_degree(16)
    qdom = tdom.create_disjoint_domain(16 << chip.log_quotient_degree)
    qn = qdom.size
    main_q = rand_f((qn, width))
    perm_q = rand_f((qn, 4 * chip.perm_width))
    pv = rand_f(npv)
    nc = chip.num_constraints
    alphas = rand_f((nc + 3, 4))  # a longer shared table: the tail is used
    pc = (rand_f(4), rand_f(4))
    cum, gsum = rand_f(4), rand_f(14)
    step = qn // tdom.size
    sels = tfolder.selectors_on_coset(tdom.log_n, tdom.shift, qdom.log_n, qdom.shift, "cpu")
    got = tfolder.quotient(
        chip, step, t(np.zeros((qn, 0), np.uint32)), t(main_q), t(perm_q), sels,
        [int(v) for v in pv], t(alphas), (t(pc[0]), t(pc[1])), t(cum), gsum,
    )
    jsels = jfolder.selectors_on_coset_device(tdom.log_n, tdom.shift, qdom.log_n, qdom.shift)
    want = jfolder._quotient_body(
        chip, step, j(np.zeros((qn, 0))), j(main_q), j(perm_q), jsels, j(pv),
        j(alphas[alphas.shape[0] - nc :]), (j(pc[0]), j(pc[1])), j(cum), j(gsum),
    )
    assert np.array_equal(h(got), jf.to_host(want))


@pytest.fixture(scope="module")
def mips_shard():
    from ziren_tpu.executor.asm import fibonacci_program
    from ziren_tpu.machine.mips import execute, mips_machine
    from ziren_tpu.stark.shape import _gen_traces

    program = fibonacci_program(30)
    machine = mips_machine(dev_config())
    pk, _vk = machine.setup(program)
    _ex, record = execute(program)
    traces = {c.name: (c, tr) for c, tr in _gen_traces(machine, record)}
    pv = record.public_values
    pv = pv.to_list() if hasattr(pv, "to_list") else list(pv)
    return machine, pk, traces, pv


@pytest.mark.parametrize("name", ["Cpu", "Program", "Global"])
def test_mips_chip_matches_host_folders(mips_shard, name):
    """Perm trace and quotient of MIPS chips (one with a preprocessed trace,
    the Global chip with its septic sums) against the host numpy folders."""
    machine, pk, traces, pv = mips_shard
    chip, trace = traces[name]
    prep = pk.preprocessed_by_name.get(name)
    challenges = (rand_f(4), rand_f(4))

    fl = TraceFolder(prep, trace, pv)
    chip.air.eval(fl)
    perm, cumsum = generate_permutation_trace(
        fl.sends, fl.receives, trace.shape[0], challenges, chip.batch_size
    )
    got, cum = tfolder.perm_trace(
        chip, t(trace), None if prep is None else t(prep), pv,
        t(challenges[0]), t(challenges[1]),
    )
    assert np.array_equal(h(got), perm.reshape(trace.shape[0], -1))
    assert np.array_equal(h(cum), cumsum)

    # quotient over arbitrary coset values: the fold is a fixed polynomial
    # map of its inputs, so any inputs compare the two folders
    tdom = natural_domain_for_degree(trace.shape[0])
    qdom = tdom.create_disjoint_domain(trace.shape[0] << chip.log_quotient_degree)
    qn, step = qdom.size, qdom.size // tdom.size
    prep_q = rand_f((qn, chip.preprocessed_width))
    main_q = rand_f((qn, chip.width))
    perm_q = rand_f((qn, 4 * chip.perm_width))
    alpha = rand_f(4)
    gsum = trace[-1, -14:].astype(np.uint32) if name == "Global" else np.zeros(14, np.uint32)
    sels = _sels_host(tdom, qdom)
    roll = lambda m: np.roll(m, -step, axis=0)
    folder = QuotientFolder(
        prep_local=list(prep_q.T), prep_next=list(roll(prep_q).T),
        main_local=list(main_q.T), main_next=list(roll(main_q).T),
        sels=sels, public_values=pv,
        powers_of_alpha_rev=E.epowers(alpha, chip.num_constraints)[::-1].copy(),
        perm_challenges=challenges, local_cumulative_sum=cumsum,
        global_cumulative_sum=gsum,
    )
    ext_cols = lambda m: [m[:, 4 * c : 4 * c + 4] for c in range(m.shape[1] // 4)]
    folder.set_perm(ext_cols(perm_q), ext_cols(roll(perm_q)))
    chip.eval_with_perm(folder)
    want = E.emul_base(folder.acc, sels["inv_zeroifier"])

    from ziren_tpu_torch.ops import tpcs

    got_q = tfolder.quotient(
        chip, step, t(prep_q), t(main_q), t(perm_q),
        tfolder.selectors_on_coset(tdom.log_n, tdom.shift, qdom.log_n, qdom.shift, "cpu"),
        pv, tpcs.epowers_rev(t(alpha), chip.num_constraints + 5),
        (t(challenges[0]), t(challenges[1])), t(cumsum), gsum,
    )
    assert np.array_equal(h(got_q), want)
