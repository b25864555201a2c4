"""A two-column Fibonacci AIR for the STARK engine alone, outside the MIPS
machine: the engine proof that the Groth16 driver (tools/groth16_wrap.py)
compresses, shrinks and wraps.

    machine = StarkMachine(dev_config(), [FibonacciAir()], num_public_values=3)
    pk, vk = machine.setup()
    proof = machine.prove(pk, [Record(n=16, pv=fib_pv(16))], device="cpu")

Public values: the first row (0, 1) and the last row's second column.
"""

from __future__ import annotations

import numpy as np

from ..core import field as F
from ..stark.chip import Air


class FibonacciAir(Air):
    name = "Fibonacci"
    width = 2

    def eval(self, b):
        a_l, b_l = b.main_local
        a_n, b_n = b.main_next
        b.when_first_row().assert_eq(a_l, b.public_values[0])
        b.when_first_row().assert_eq(b_l, b.public_values[1])
        b.when_transition().assert_eq(a_n, b_l)
        b.when_transition().assert_eq(b_n, a_l + b_l)
        b.when_last_row().assert_eq(b_l, b.public_values[2])

    def generate_trace(self, record, output):
        n = record.n
        tr = np.zeros((n, 2), dtype=np.uint32)
        a, b = 0, 1
        for i in range(n):
            tr[i] = (a, b)
            a, b = b, (a + b) % F.P_INT
        return tr


class Record:
    """One shard of the engine machine: its row count and public values
    (sent and mults feed lookup AIRs and stay None here)."""

    def __init__(self, n=8, sent=None, mults=None, pv=None):
        self.n = n
        self.sent = sent
        self.mults = mults
        self.public_values = pv or []


def fib_pv(n):
    """The public values of an n-row FibonacciAir trace."""
    a, b = 0, 1
    for _ in range(n - 1):
        a, b = b, (a + b) % F.P_INT
    return [0, 1, b]
