"""Duplex-sponge Fiat-Shamir challenger (host, exact reference semantics).

Matches `DuplexChallenger<KoalaBear, Poseidon2KoalaBear<16>, 16, 8>` as pinned
by the reference's in-circuit reimplementation
(crates/recursion/circuit/src/challenger.rs):

  * observe(x): clear output buffer, push x to input buffer; duplex when the
    input buffer reaches 8.
  * duplexing: overwrite state[0..len(inputs)], permute, output buffer =
    state[0..8] (samples pop from the END, i.e. state[7] first).
  * sample(): duplex if input buffer nonempty or output buffer empty; pop.
  * sample_bits(n): low n bits (little-endian) of a sampled felt (NUM_BITS=31).
  * sample_ext(): 4 samples as coefficients [a, b, c, d].
  * check_witness(bits, w): observe(w) then sample_bits(bits) == 0.
"""

from __future__ import annotations

import numpy as np

from . import poseidon2 as p2

WIDTH = 16
RATE = 8
NUM_BITS = 31


class DuplexChallenger:
    def __init__(self):
        self.state = np.zeros(WIDTH, dtype=np.uint32)
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger()
        c.state = self.state.copy()
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplexing(self) -> None:
        assert len(self.input_buffer) <= RATE
        for i, x in enumerate(self.input_buffer):
            self.state[i] = x
        self.input_buffer.clear()
        self.state = p2.permute(self.state)
        self.output_buffer = [int(v) for v in self.state[:RATE]]

    def observe(self, value) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(int(value))
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_slice(self, values) -> None:
        for v in np.asarray(values, dtype=np.uint32).reshape(-1):
            self.observe(v)

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def sample_ext(self) -> np.ndarray:
        return np.array(
            [self.sample(), self.sample(), self.sample(), self.sample()],
            dtype=np.uint32,
        )

    def sample_bits(self, nb_bits: int) -> int:
        assert nb_bits <= NUM_BITS
        return self.sample() & ((1 << nb_bits) - 1)

    def check_witness(self, nb_bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(nb_bits) == 0

    def grind(self, nb_bits: int) -> int:
        """Find the smallest nonneg integer witness passing check_witness.

        Deterministic, matching p3's GrindingChallenger::grind. Candidates are
        tried in vectorized batches (each try is one permutation on a clone).
        """
        batch = 4096
        base_state = self.state.copy()
        n_in = len(self.input_buffer)
        assert n_in < RATE  # observe(witness) always triggers one duplex iff full
        start = 0
        while True:
            cands = np.arange(start, start + batch, dtype=np.uint32)
            states = np.broadcast_to(base_state, (batch, WIDTH)).copy()
            if n_in:
                states[:, :n_in] = np.asarray(self.input_buffer, dtype=np.uint32)
            if n_in + 1 == RATE:
                # observing the witness fills the buffer -> duplex immediately
                states[:, n_in] = cands
                out = p2.permute(states)
                samples = out[:, RATE - 1]
            else:
                # buffer not full: the subsequent sample() triggers the duplex
                states[:, n_in] = cands
                out = p2.permute(states)
                samples = out[:, RATE - 1]
            hits = np.nonzero((samples & np.uint32((1 << nb_bits) - 1)) == 0)[0]
            if hits.size:
                witness = int(cands[hits[0]])
                ok = self.check_witness(nb_bits, witness)
                assert ok
                return witness
            start += batch
