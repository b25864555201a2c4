"""Device-resident duplex-sponge Fiat-Shamir challenger (counterpart of
ops/jchallenger.py).

Bit-exact mirror of core/challenger.py (DuplexChallenger<KoalaBear,
Poseidon2, 16, 8>) with the sponge state held as a device tensor. The
buffer structure (how many values are pending, when a duplex fires) is
host-side Python: it is fixed by the proof's shape, not by field values,
so a prove driven through this challenger never waits on a transcript
value, except in the proof-of-work grind, which checks one batch of
candidates at a time.

Values are canonical int64 tensors: 0-d scalars, (k,) vectors, or host
values observed through `observe_host_slice`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tposeidon2 as tp2

WIDTH = 16
RATE = 8
NUM_BITS = 31
GRIND_BATCH = 1 << 14


def _duplex(state: torch.Tensor, inputs: torch.Tensor, k: int) -> torch.Tensor:
    """Overwrite state[:k] with inputs (k,) and permute."""
    if k:
        state = torch.cat([inputs, state[k:]])
    return tp2.permute(state)


def _grind(state, inputs, nb_bits: int, n_in: int, batch: int = GRIND_BATCH) -> int:
    """Smallest nonnegative witness w such that duplexing [inputs, w] gives
    a sample with nb_bits low bits zero (mirrors DuplexChallenger.grind).
    Candidates are tried in batches in order, and the first hit of the first
    batch that has one is the smallest."""
    mask = (1 << nb_bits) - 1
    dev = state.device
    head = inputs.expand(batch, n_in) if n_in else None
    tail = state[n_in + 1 :].expand(batch, WIDTH - n_in - 1)
    start = 0
    while True:
        cands = torch.arange(start, start + batch, dtype=torch.int64, device=dev)
        parts = ([head] if n_in else []) + [cands[:, None], tail]
        out = tp2.permute(torch.cat(parts, dim=1))
        hits = ((out[:, RATE - 1] & mask) == 0).to(torch.int32)
        found, idx = torch.max(hits, dim=0)  # first maximal index
        if int(found):
            return start + int(idx)
        start += batch


class TChallenger:
    """Device challenger. The input buffer holds segments (0-d or 1-d
    tensors) concatenated only at duplex time; the output buffer is the
    post-permute state plus a host-side count."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.state = torch.zeros(WIDTH, dtype=torch.int64, device=self.device)
        self.input_buffer: list = []  # segments; total length _buf_n
        self._buf_n = 0
        self._out_len = 0  # output buffer = state[:_out_len], popped at end

    @classmethod
    def from_host(cls, host_ch, device) -> "TChallenger":
        c = cls(device)
        c.state = torch.as_tensor(
            np.asarray(host_ch.state, np.int64), device=c.device
        )
        if host_ch.input_buffer:
            seg = torch.as_tensor(
                np.asarray(host_ch.input_buffer, np.int64), device=c.device
            )
            c.input_buffer = [seg]
            c._buf_n = int(seg.numel())
        # host output_buffer is always a prefix of state[:RATE]
        c._out_len = len(host_ch.output_buffer)
        if c._out_len:
            assert list(host_ch.output_buffer) == [
                int(v) for v in host_ch.state[: c._out_len]
            ]
        return c

    def _concat_buffer(self) -> torch.Tensor:
        if not self._buf_n:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        parts = [torch.atleast_1d(v) for v in self.input_buffer]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _duplexing(self) -> None:
        k = self._buf_n
        assert k <= RATE
        inputs = self._concat_buffer()
        self.input_buffer.clear()
        self._buf_n = 0
        self.state = _duplex(self.state, inputs, k)
        self._out_len = RATE

    def _push(self, seg: torch.Tensor, n: int) -> None:
        self._out_len = 0
        i = 0
        while i < n:
            take = min(RATE - self._buf_n, n - i)
            self.input_buffer.append(seg if i == 0 and take == n else seg[i : i + take])
            self._buf_n += take
            i += take
            if self._buf_n == RATE:
                self._duplexing()

    # -- observe ------------------------------------------------------------
    def observe(self, value: torch.Tensor) -> None:
        """value: 0-d device tensor."""
        self._out_len = 0
        self.input_buffer.append(value)
        self._buf_n += 1
        if self._buf_n == RATE:
            self._duplexing()

    def observe_vec(self, vec: torch.Tensor) -> None:
        """(k,) device vector, buffered as whole segments."""
        self._push(vec, int(vec.shape[0]))

    def observe_host_slice(self, values) -> None:
        """Canonical host ints/array."""
        seg = torch.as_tensor(
            np.asarray(values, np.uint32).reshape(-1).astype(np.int64),
            device=self.device,
        )
        self._push(seg, int(seg.numel()))

    # -- sample -------------------------------------------------------------
    def sample(self) -> torch.Tensor:
        if self._buf_n or not self._out_len:
            self._duplexing()
        self._out_len -= 1
        return self.state[self._out_len]

    def sample_ext(self) -> torch.Tensor:
        """(4,) device ext element [s0, s1, s2, s3] in sampling order."""
        if not self._buf_n and self._out_len >= 4:
            s = self.state[self._out_len - 4 : self._out_len].flip(0)
            self._out_len -= 4
            return s
        return torch.stack([self.sample() for _ in range(4)])

    def sample_bits(self, nb_bits: int) -> torch.Tensor:
        assert nb_bits <= NUM_BITS
        return self.sample() & ((1 << nb_bits) - 1)

    def grind(self, nb_bits: int) -> int:
        """Proof of work: returns the smallest witness (a host int, read
        back batch by batch) and replays observe(witness) + sample_bits on
        the transcript."""
        n_in = self._buf_n
        assert n_in < RATE
        w = _grind(self.state, self._concat_buffer(), nb_bits, n_in)
        self.observe(torch.tensor(w, dtype=torch.int64, device=self.device))
        self.sample_bits(nb_bits)  # transcript replay of check_witness
        return w
