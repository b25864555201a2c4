"""Prover state carried in and out of the package as numpy arrays and bytes.

A proving key is its preprocessed traces, their commitment and the extra
transcript observations; a shard proof is its serialized bytes. These
functions take and give nothing else, so state made by another
implementation of the same prover (the JAX package beside this one) crosses
over without either side importing the other's classes.
"""

from __future__ import annotations

import numpy as np

from .machine import ProvingKey, VerifyingKey
from .proof import MachineProof, ShardProof
from .serialize import deserialize_shard_proof


def proving_key_arrays(pk) -> dict:
    """pk -> {"commit": (8,) uint32, "traces": {chip name: (h, w) uint32},
    "extra_observations": [int]}; traces in the order they were committed."""
    order = sorted(pk.chip_ordering, key=pk.chip_ordering.get)
    return {
        "commit": np.array(pk.commit, dtype=np.uint32),
        "traces": {n: np.array(pk.preprocessed_by_name[n], dtype=np.uint32) for n in order},
        "extra_observations": [int(x) for x in pk.vk.extra_observations],
    }


def proving_key_from_arrays(machine, commit, traces: dict, extra_observations=()):
    """Rebuild (pk, vk) for `machine` from preprocessed traces by chip name
    and the commitment that came with them. The traces are committed again
    here (the prover needs the committed data, which is not carried), and a
    commitment that differs from `commit` raises ValueError."""
    named = [(machine.chip_by_name[n], np.asarray(t, np.uint32)) for n, t in traces.items()]
    for chip, t in named:
        if t.ndim != 2 or t.shape[1] != chip.preprocessed_width:
            raise ValueError(f"{chip.name}: bad preprocessed trace {t.shape}")
    named.sort(key=lambda ct: -ct[1].shape[0])
    pcs = machine.config.pcs
    domains = [pcs.natural_domain_for_degree(t.shape[0]) for _c, t in named]
    got, data = pcs.commit(list(zip(domains, [t for _c, t in named])))
    if not np.array_equal(np.asarray(got, np.uint32), np.asarray(commit, np.uint32)):
        raise ValueError("preprocessed commitment differs from the one carried in")
    info = [(c.name, d, t.shape, c.local_only) for (c, t), d in zip(named, domains)]
    vk = VerifyingKey(got, info, [int(x) for x in extra_observations])
    pk = ProvingKey(
        commit=got,
        data=data,
        chip_ordering={c.name: i for i, (c, _t) in enumerate(named)},
        chip_information=info,
        preprocessed_by_name={c.name: t for c, t in named},
        vk=vk,
    )
    return pk, vk


def shard_proof_from_bytes(data: bytes) -> ShardProof:
    return deserialize_shard_proof(bytes(data))


def machine_proof_from_shard_bytes(shards) -> MachineProof:
    """[bytes of one shard proof, ...] -> MachineProof."""
    return MachineProof([shard_proof_from_bytes(b) for b in shards])
