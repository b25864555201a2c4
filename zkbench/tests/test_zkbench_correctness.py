"""The comparison that decides `correct`, shown to fail.

On the CPU, at a size a test run holds (the port's plain PyTorch kernels),
a whole run of a cell is driven without the harness's look for a card:

- sound, it comes out correct;
- with the timed path broken underneath (prove_hook), it comes out not
  correct, once for each fault a proving cell can have: a request answered
  with an earlier request's proof (its state unchanged), a proof with half
  its shards left out, and an answer altered where it is produced (the
  public values returned, a value the proof opens);
- the control: the program proving with one FRI query fewer than the
  configuration states (its own FRI_QUERIES path, at the core config)
  comes out not correct.

The control at the cells' own sizes runs on the card
(test_control_on_the_card, marked cuda), and as the chip runs PERF.md
gives.

    python -m pytest -q zkbench/tests/test_zkbench_correctness.py
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import pytest

from zkbench import cells
from zkbench.harness import run_cell

DEV_FRI = {"log_blowup": 1, "num_queries": 8, "proof_of_work_bits": 4}


def small(name: str, stark_config: str = "dev", guest_args=None):
    """The cell at a size a CPU test holds: fibonacci(250) in two shards of
    1,024 cycles, or 4 SHA rounds, at the dev (or core) config."""
    cell = cells.Bench().cell(name)
    fri = DEV_FRI if stark_config == "dev" else cell.config["fri"]
    cell.config = {**cell.config, "stark_config": stark_config, "shard_size": 1024,
                   "fri": fri, "guest_args": {}}
    args = guest_args or ({"n": 250} if cell.config["guest"] == "fib" else {"rounds": 4})
    cell.traffic = {**cell.traffic, "guest_args": args}
    return cell


def test_a_sound_run_is_correct():
    result = run_cell(small("fib-core.prove-n58218"), 2**40 + 1, 0, trace=False, device="cpu")
    assert result["correct"], result["why_not"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"prove_khz", "setup_s"}
    assert list(result)[-1] == "checks"


def test_the_sha_chain_is_correct():
    result = run_cell(small("sha2chain-core.prove"), 2**40 + 2, 0, trace=False, device="cpu")
    assert result["correct"], result["why_not"]


def stale(prove):
    """Every request after the first answered with the first one's proof."""
    first = []

    def broken(pk, stdin):
        if not first:
            first.append(prove(pk, stdin))
        return first[0]
    return broken


def half_shards(prove):
    def broken(pk, stdin):
        out = prove(pk, stdin)
        out.proof.shard_proofs = out.proof.shard_proofs[: len(out.proof.shard_proofs) // 2]
        return out
    return broken


def altered_words(prove):
    def broken(pk, stdin):
        out = prove(pk, stdin)
        out.public_values.words[0] ^= 1
        return out
    return broken


def altered_opening(prove):
    def broken(pk, stdin):
        out = prove(pk, stdin)
        sp = out.proof.shard_proofs[0]
        vals = sp.opened_values[0].main.local
        vals[0] = (vals[0] + 1) % 2130706433
        return out
    return broken


@pytest.mark.parametrize("fault,caught_by", [
    (stale, "words_wrong"), (half_shards, "proofs_rejected"),
    (altered_words, "words_wrong"), (altered_opening, "proofs_rejected")])
def test_a_broken_timed_path_is_not_correct(fault, caught_by):
    result = run_cell(small("fib-core.prove-n58218"), 2**40 + 5, 0, trace=False, device="cpu",
                      prove_hook=fault)
    assert not result["correct"]
    assert result["checks"][caught_by]["value"] > result["checks"][caught_by]["limit"]


def test_the_control_is_not_correct(monkeypatch):
    """One FRI query fewer than the core config's 84 (the port's FRI_QUERIES);
    the same run at 84 is correct."""
    cell = small("fib-core.prove-n58218", "core", {"n": 60})
    sound = run_cell(copy.deepcopy(cell), 2**40 + 9, 0, trace=False, device="cpu")
    assert sound["correct"], sound["why_not"]
    monkeypatch.setenv("FRI_QUERIES", "83")
    control = run_cell(cell, 2**40 + 9, 0, trace=False, device="cpu")
    assert not control["correct"]
    assert control["checks"]["proofs_rejected"]["value"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in cells.Bench().spec["workloads"]])
def test_control_on_the_card(name):
    """The control at the cell's own size on the card: the command's run with
    FRI_QUERIES=83 prints correct false."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ, FRI_QUERIES="83")
    out = subprocess.run([sys.executable, "zkbench/run.py", "--workload", name, "--seed",
                          str(2**33 + 17), "--seconds", "1", "--trace", "0"],
                         cwd=cells.CHECKOUT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert not result["correct"] and result["checks"]["proofs_rejected"]["value"] >= 1
