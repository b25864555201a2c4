"""The device data of proving keys is bounded (stark/tprover.py:device_pk).

The torch prover commits a key's preprocessed traces on the device once and
keeps that commit and the traces in a table of at most
tprover._DEVICE_KEYS_MAX entries, the least recently used evicted first,
each key held weakly. The keys here are a one-chip machine's whose
preprocessed trace is made from the `program` handed to setup (an int), so
that a key is cheap and as many distinct keys as a test needs can be made.
That one compress commits each of its keys once on the device, as when each
key kept its own commit, is held where a compress is already made:
tests/test_torch_compress.py."""

import gc
import os

import numpy as np
import pytest
import torch

from ziren_tpu_torch.core import field as F
from ziren_tpu_torch.ops import tpcs
from ziren_tpu_torch.stark import tprover
from ziren_tpu_torch.stark.chip import Air
from ziren_tpu_torch.stark.config import dev_config
from ziren_tpu_torch.stark.machine import StarkMachine
from ziren_tpu_torch.stark.serialize import serialize_machine_proof
from ziren_tpu_torch.tools.engine_air import Record

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = torch.device("cpu")


class KeyedAir(Air):
    """One main column equal to the preprocessed one, 16 rows of
    program + row index."""

    name = "Keyed"
    width = 1
    preprocessed_width = 1

    def generate_preprocessed(self, program):
        return ((np.arange(16) + program) % F.P_INT).astype(np.uint32)[:, None]

    def generate_trace(self, record, output):
        return ((np.arange(16) + record.program) % F.P_INT).astype(np.uint32)[:, None]

    def eval(self, b):
        b.assert_eq(b.main_local[0], b.prep_local[0])


def keyed(program):
    machine = StarkMachine(dev_config(), [KeyedAir()], num_public_values=0)
    pk, vk = machine.setup(program)
    record = Record(n=16)
    record.program = program
    return machine, pk, vk, record


def held(pk) -> list:
    return [dev for key, dev in tprover.device_keys() if key is pk]


@pytest.fixture
def empty_table():
    """The table as a process starts with it, and after the test."""
    with tprover._PK_LOCK:
        tprover._DEVICE_KEYS.clear()
    yield
    with tprover._PK_LOCK:
        tprover._DEVICE_KEYS.clear()


def test_the_table_holds_at_most_its_bound(empty_table):
    bound = tprover._DEVICE_KEYS_MAX
    keys = [keyed(k) for k in range(bound + 3)]
    for i, (machine, pk, vk, record) in enumerate(keys):
        assert machine.verify(vk, machine.prove(pk, [record], device="cpu"))
        assert len(tprover.device_keys()) == min(i + 1, bound)
        assert held(pk) == [CPU]
    # the least recently used went first
    assert [key for key, _dev in tprover.device_keys()] == [pk for _m, pk, _v, _r in keys[3:]]


def test_a_dead_keys_entry_goes(empty_table):
    machine, pk, _vk, record = keyed(7)
    machine.prove(pk, [record], device="cpu")
    assert held(pk) == [CPU]
    del pk
    gc.collect()
    assert tprover.device_keys() == []


def test_an_evicted_key_is_committed_again(empty_table):
    machine, pk, vk, record = keyed(11)
    first = serialize_machine_proof(machine.prove(pk, [record], device="cpu"))
    others = [keyed(100 + k) for k in range(tprover._DEVICE_KEYS_MAX)]
    for m, p, _v, r in others:
        m.prove(p, [r], device="cpu")
    assert held(pk) == []
    commits = []
    real = tpcs.commit
    tpcs.commit = lambda *a, **kw: commits.append(1) or real(*a, **kw)
    try:
        again = machine.prove(pk, [record], device="cpu")
    finally:
        tpcs.commit = real
    assert held(pk) == [CPU]
    assert len(commits) == 4  # the preprocessed commit again, then main, permutation, quotient
    assert serialize_machine_proof(again) == first
    assert machine.verify(vk, again)
