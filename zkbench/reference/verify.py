"""The reference's judgement of proofs: its own verifying key, worked out
from the guest it builds itself, and a STARK verification of the proof bytes
with the frozen copy of the port's host verifier (zkvm/), shards spread over
worker processes, then the machine-wide checks: the global cumulative sum,
the chaining of shards, the entry pc, the halt, and the committed digest
against the words the reference expects.

    judge = Judge(guest_module, guest_args, fri={"log_blowup": 1, ...})
    errors = judge.verify([proof_bytes, ...], [expected_words, ...], workers=4)

The FRI parameters come from the configuration's file, never from the
environment, so that a program that proves with other parameters fails.
The workers are plain subprocesses (`python -m zkbench.reference.verify`)
fed pickles through their pipes: no shared-memory semaphores, nothing
written outside the run's own pipes."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from .zkvm.executor import asm as ref_asm
from .zkvm.machine.mips import mips_machine, verify_mips_proof
from .zkvm.stark.config import StarkConfig
from .zkvm.stark.pcs import FriConfig
from .zkvm.stark.serialize import deserialize_machine_proof
from .zkvm.stark.verifier import VerificationError, verify_shard

_WORKER: dict = {}


def reference_machine(fri: dict):
    return mips_machine(StarkConfig(FriConfig(**fri)))


def _init_worker(fri: dict, vk) -> None:
    machine = reference_machine(fri)
    base = machine.config.challenger()
    vk.observe_into(base)
    _WORKER.update(machine=machine, vk=vk, base=base)


def _verify_one(shard_proof) -> str | None:
    try:
        verify_shard(_WORKER["machine"], _WORKER["vk"], shard_proof, _WORKER["base"].clone())
    except (VerificationError, ValueError, IndexError, KeyError, AssertionError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def digest_words(public_values) -> list:
    """The 8 committed digest words of a shard's public values (32 byte felts,
    little-endian words)."""
    pv = [int(v) for v in public_values[:32]]
    return [pv[4 * i] | pv[4 * i + 1] << 8 | pv[4 * i + 2] << 16 | pv[4 * i + 3] << 24
            for i in range(8)]


class Judge:
    def __init__(self, guest, guest_args: dict, fri: dict):
        self.fri = dict(fri)
        self.program = guest.build(ref_asm, **guest_args)
        self.machine = reference_machine(self.fri)
        _pk, self.vk = self.machine.setup(self.program,
                                          extra_observations=[self.program.pc_start])

    def _in_workers(self, shard_proofs: list, n: int) -> list:
        """_verify_one over shard_proofs in n worker processes, in order."""
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        parts = [list(range(i, len(shard_proofs), n)) for i in range(n)]

        def work(idx: list) -> list:
            proc = subprocess.Popen([sys.executable, "-m", "zkbench.reference.verify"],
                                    cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            out, _ = proc.communicate(pickle.dumps(
                (self.fri, self.vk, [shard_proofs[i] for i in idx])))
            if proc.returncode != 0:
                return [f"verifier worker exited with {proc.returncode}"] * len(idx)
            return pickle.loads(out)

        results = [None] * len(shard_proofs)
        with ThreadPoolExecutor(n) as threads:
            for idx, got in zip(parts, threads.map(work, parts)):
                for i, r in zip(idx, got):
                    results[i] = r
        return results

    def verify(self, proofs: list, expected_words: list, workers: int = 1) -> list:
        """One entry a proof: None if it verifies and commits the expected
        words (padded with zeros to 8), else why not."""
        parsed, errors = [], [None] * len(proofs)
        for i, data in enumerate(proofs):
            try:
                parsed.append(deserialize_machine_proof(data))
            except Exception as e:  # malformed bytes are a wrong answer, not a crash
                parsed.append(None)
                errors[i] = f"unreadable proof: {type(e).__name__}: {e}"
        jobs = [(i, sp) for i, mp in enumerate(parsed) if mp is not None
                for sp in mp.shard_proofs]
        if workers > 1 and len(jobs) > 1:
            results = self._in_workers([sp for _, sp in jobs], min(workers, len(jobs)))
        else:
            _init_worker(self.fri, self.vk)
            results = [_verify_one(sp) for _, sp in jobs]
        for (i, _sp), err in zip(jobs, results):
            if err is not None and errors[i] is None:
                errors[i] = f"shard rejected: {err}"
        # the machine-wide rules, each shard's STARK already checked above
        self.machine.verify = self._global_sum_only
        for i, mp in enumerate(parsed):
            if errors[i] is not None:
                continue
            try:
                verify_mips_proof(self.machine, self.vk, mp, pc_start=self.program.pc_start)
            except VerificationError as e:
                errors[i] = f"machine rule broken: {e}"
                continue
            want = list(expected_words[i]) + [0] * (8 - len(expected_words[i]))
            got = digest_words(mp.shard_proofs[-1].public_values)
            if got != want:
                errors[i] = f"committed digest {got} is not the reference's {want}"
        del self.machine.verify
        return errors

    def _global_sum_only(self, vk, proof) -> bool:
        """StarkMachine.verify without its per-shard part (done in `verify`)."""
        from .zkvm.core import septic as S

        if not proof.shard_proofs:
            raise VerificationError("empty proof")
        digests = []
        for sp in proof.shard_proofs:
            for name, vals in zip(sp.chip_names, sp.opened_values):
                if self.machine.chip_by_name[name].commit_scope.name == "Global":
                    g = vals.global_cumulative_sum
                    digests.append((g[:7], g[7:14]))
        if digests and not S.digests_balance(digests):
            raise VerificationError("global cumulative sum does not balance")
        return True


def _serve() -> None:
    """A worker: (fri, vk, shard proofs) pickled on stdin, the list of
    _verify_one's answers pickled on stdout."""
    fri, vk, shard_proofs = pickle.load(sys.stdin.buffer)
    _init_worker(fri, vk)
    pickle.dump([_verify_one(sp) for sp in shard_proofs], sys.stdout.buffer)


if __name__ == "__main__":
    _serve()
