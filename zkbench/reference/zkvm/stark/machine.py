"""StarkMachine: chip set + setup + machine-level prove/verify, and the
device prove of every shard of an execution (`prove`, also reached through
`StarkMachine.prove`).

(reference: crates/stark/src/machine.rs — setup commits preprocessed traces
into pk/vk; verify replays every shard with a cloned challenger and checks
the global septic digest sum; here the global digest check is wired once the
Global chip lands, the local cumulative-sum check is per shard.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .chip import Chip
from .proof import MachineProof  # noqa: F401  (the copy keeps the source's names)
from .verifier import verify_shard, VerificationError


@dataclass
class ProvingKey:
    commit: np.ndarray
    data: object  # pcs ProverData or None
    chip_ordering: dict  # chip name -> index in preprocessed batch
    chip_information: list  # (name, Domain, (h, w), local_only)
    preprocessed_by_name: dict  # name -> trace
    vk: "VerifyingKey"


@dataclass
class VerifyingKey:
    commit: np.ndarray
    chip_information: list  # (name, Domain, (h, w), local_only)
    extra_observations: list = field(default_factory=list)
    commit_kind: str = "kb"  # "kb" | "bn254" (outer/wrap config)

    def observe_into(self, ch):
        if self.commit_kind == "bn254":
            # outer config: the vk commit is ONE Fr digest; the multifield
            # challenger duplexes on demand, no rate padding convention
            ch.observe_fr(int(self.commit))
            for x in self.extra_observations:
                ch.observe(int(x))
            return
        ch.observe_slice(np.asarray(self.commit, np.uint32))
        for x in self.extra_observations:
            ch.observe(int(x))
        total = 8 + len(self.extra_observations)
        pad = (-total) % 8
        for _ in range(pad):
            ch.observe(0)


class StarkMachine:
    def __init__(self, config, airs, num_public_values=0):
        self.config = config
        self.chips = [Chip(a, num_public_values) for a in airs]
        self.chip_by_name = {c.name: c for c in self.chips}
        self.num_public_values = num_public_values

    def setup(self, program=None, extra_observations=None):
        pcs = self.config.pcs
        named = []
        for chip in self.chips:
            prep = chip.air.generate_preprocessed(program)
            if prep is not None:
                assert prep.shape[1] == chip.preprocessed_width, chip.name
                named.append((chip, np.asarray(prep, np.uint32)))
        named.sort(key=lambda t: -t[1].shape[0])
        if named:
            domains = [pcs.natural_domain_for_degree(t.shape[0]) for _, t in named]
            commit, data = pcs.commit(list(zip(domains, [t for _, t in named])))
            info = [
                (c.name, d, t.shape, c.local_only)
                for (c, t), d in zip(named, domains)
            ]
        elif getattr(self.config, "commit_kind", "kb") == "bn254":
            commit, data, info = 0, None, []  # zero Fr digest
        else:
            commit, data, info = np.zeros(8, dtype=np.uint32), None, []
        vk = VerifyingKey(
            commit, info, list(extra_observations or []),
            commit_kind=getattr(self.config, "commit_kind", "kb"),
        )
        pk = ProvingKey(
            commit=commit,
            data=data,
            chip_ordering={c.name: i for i, (c, _) in enumerate(named)},
            chip_information=info,
            preprocessed_by_name={c.name: t for c, t in named},
            vk=vk,
        )
        return pk, vk

    def verify(self, vk, proof: MachineProof) -> bool:
        base = self.config.challenger()
        vk.observe_into(base)
        if not proof.shard_proofs:
            raise VerificationError("empty proof")
        for sp in proof.shard_proofs:
            ch = base.clone()
            verify_shard(self, vk, sp, ch)
        # global septic digest balance across shards
        # (reference: machine.rs:659-674)
        from ..core import septic as S

        digests = []
        for sp in proof.shard_proofs:
            for name, vals in zip(sp.chip_names, sp.opened_values):
                if self.chip_by_name[name].commit_scope.name == "Global":
                    g = vals.global_cumulative_sum
                    digests.append((g[:7], g[7:14]))
        if digests and not S.digests_balance(digests):
            raise VerificationError("global cumulative sum does not balance")
        return True

