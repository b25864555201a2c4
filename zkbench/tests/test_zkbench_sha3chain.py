"""The sha3chain-core cell on the CPU, at 4 rounds (the port's plain PyTorch
kernels): its guest, its plain reference (reference/sha3chain.py) and the
comparison that decides `correct`.

- the reference's Keccak-256 gives the published vectors, and not SHA3-256;
- the executor's cycle count is the reference's;
- a sound run is correct at the dev config and at the core config;
- an altered committed word, and a proof with half its shards, are not.

    python -m pytest -q zkbench/tests/test_zkbench_sha3chain.py
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from zkbench.harness import run_cell
from zkbench.reference import sha3chain as ref
from zkbench.tests.test_zkbench_correctness import altered_words, half_shards, small

CELL = "sha3chain-core.prove"


@pytest.mark.parametrize("data,digest", [
    (b"", "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"),
    (b"abc", "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")])
def test_keccak256_gives_the_published_vectors(data, digest):
    assert ref.keccak256(data).hex() == digest
    assert ref.keccak256(data) != hashlib.sha3_256(data).digest()  # the padding differs


@pytest.mark.parametrize("rounds", [1, 4])
def test_the_cycle_count_is_the_references(rounds):
    from ziren_tpu_torch.executor import asm
    from ziren_tpu_torch.executor.executor import Executor

    cell = small(CELL)
    guest = cell.guest()
    buf = guest.inputs(np.random.default_rng([2**40 + 3, 1]), rounds)
    ex = Executor(guest.build(asm, rounds), shard_size=1 << 22)
    ex.input_stream.extend(buf)
    ex.run_sharded()
    want = ref.expected(buf, rounds)
    assert ex.global_clk == want["cycles"] == 48 + 24 * rounds
    got = [ex.memory[0x4000 + 4 * j][0] for j in range(8)]
    assert got == want["words"]


@pytest.mark.parametrize("stark_config", ["dev", "core"])
def test_a_sound_run_is_correct(stark_config):
    result = run_cell(small(CELL, stark_config), 2**40 + 11, 0, trace=False, device="cpu")
    assert result["correct"], result["why_not"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())


@pytest.mark.parametrize("fault,caught_by", [
    (altered_words, "words_wrong"), (half_shards, "proofs_rejected")])
def test_a_broken_timed_path_is_not_correct(fault, caught_by):
    cell = small(CELL)
    cell.config["shard_size"] = 64  # 144 cycles: three shards, the half one
    result = run_cell(cell, 2**40 + 13, 0, trace=False, device="cpu", prove_hook=fault)
    assert not result["correct"]
    assert result["checks"][caught_by]["value"] > result["checks"][caught_by]["limit"]
    if fault is half_shards:
        assert [r[2] for r in result["requests"]] == [1]
