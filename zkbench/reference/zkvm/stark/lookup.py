"""LogUp lookup (interaction) declarations.

Mirrors the reference's `Lookup`/`LookupKind`/`LookupScope`
(reference: crates/stark/src/lookup/lookup.rs:10-65). A lookup is a multiset
message: `sends` add fingerprints with +multiplicity, `receives` with
-multiplicity; the permutation argument (permutation.py) proves the grand sum
is zero across all chips of a shard (Local scope) or across the whole machine
via the septic-curve digest (Global scope).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class LookupKind(IntEnum):
    """Argument index baked into the fingerprint (beta^0 coefficient)."""

    Memory = 1
    Program = 2
    Instruction = 3
    Byte = 4
    Range = 5
    Syscall = 6
    Global = 7
    SyscallResult = 8
    Register = 9  # recursion machine: SSA register multiset


class LookupScope(IntEnum):
    Global = 0
    Local = 1


@dataclass
class Lookup:
    """A lookup with folder-evaluated `values` and `multiplicity`.

    `values`/`multiplicity` hold folder values (numeric arrays or symbolic
    degree trackers depending on the evaluation pass).
    """

    kind: LookupKind
    values: list
    multiplicity: object
    scope: LookupScope = LookupScope.Local
