"""Chip: an AIR plus machine metadata (reference: crates/stark/src/chip.rs).

Wraps a user-defined Air object and computes, via a symbolic evaluation pass:
  * number of constraints (air + permutation), for alpha-power folding
  * max constraint degree -> log_quotient_degree
  * number of lookups -> permutation trace width
"""

from __future__ import annotations

import numpy as np

from .folder import SymbolicFolder
from .permutation import (
    eval_permutation_constraints,
    perm_trace_width,
)
from .lookup import LookupScope

BATCH_SIZE = 2


class Air:
    """Base class for user-defined AIRs.

    Subclasses define: name, width; optionally preprocessed_width, local_only,
    commit_scope; and implement eval(builder), generate_trace(record, output),
    optionally generate_preprocessed(program), included(record).
    """

    name: str = "air"
    width: int = 0
    preprocessed_width: int = 0
    local_only: bool = False
    commit_scope = LookupScope.Local
    # cycle-driven chips leave shards with no execution cycles (standalone
    # memory/precompile shards from deferred-event splitting have none)
    cycle_chip: bool = False
    # Picus determinism annotations (reference derive PicusAnnotations):
    # Layout field names whose columns a determinism checker treats as
    # free inputs vs derived outputs; requires a class-level COLS Layout.
    picus_inputs: tuple = ()
    picus_outputs: tuple = ()

    def eval(self, b):
        raise NotImplementedError

    def generate_preprocessed(self, program):
        return None

    def generate_trace(self, record, output):
        raise NotImplementedError

    def generate_dependencies(self, record, output):
        pass

    def emit_synthetic(self, record):
        """Emit synthetic ALU sub-operations into record.synthetic
        (reference: send_alu with UNUSED_PC, stark/src/air/builder.rs:282)."""
        pass

    def included(self, record) -> bool:
        return not self.cycle_chip or record.num_cycles > 0

    def num_rows(self, record):
        """Real (pre-padding) trace rows for this record, or None when
        unknown — the shape/pipeline cost model (reference cost.rs).
        Requires emit_synthetic to have run."""
        return None


_META_CACHE: dict = {}


class Chip:
    def __init__(self, air: Air, num_public_values: int = 0):
        self.air = air
        self.name = air.name
        self.width = air.width
        self.preprocessed_width = air.preprocessed_width
        self.local_only = air.local_only
        self.commit_scope = air.commit_scope
        self.batch_size = BATCH_SIZE

        # the symbolic pass depends only on the Air class (eval is pure over
        # the column layout), so its metadata is cached per class — except
        # for airs whose eval reads instance state (_no_meta_cache)
        key = (type(air), num_public_values)
        if getattr(air, "_no_meta_cache", False):
            key = (air, num_public_values)
        meta = _META_CACHE.get(key)
        if meta is None:
            fl = SymbolicFolder(
                air.preprocessed_width, air.width, num_public_values
            )
            air.eval(fl)
            num_lookups = len(fl.sends) + len(fl.receives)
            perm_width = perm_trace_width(num_lookups, BATCH_SIZE)
            if perm_width:
                fl.perm_columns(perm_width)
                eval_permutation_constraints(
                    fl, fl.sends, fl.receives, BATCH_SIZE,
                    commit_scope=air.commit_scope, main_width=air.width,
                )
            meta = (num_lookups, perm_width, fl.num_constraints,
                    max(fl.max_degree, 2))
            if len(_META_CACHE) > 512:
                _META_CACHE.clear()
            _META_CACHE[key] = meta
        (self.num_lookups, self.perm_width, self.num_constraints,
         self.max_constraint_degree) = meta
        self.log_quotient_degree = max(self.max_constraint_degree - 1, 1).bit_length() - 1
        if (1 << self.log_quotient_degree) < self.max_constraint_degree - 1:
            self.log_quotient_degree += 1

    @property
    def quotient_degree(self) -> int:
        return 1 << self.log_quotient_degree

    def eval_with_perm(self, folder):
        """Full constraint pass: air constraints then permutation constraints,
        exactly in reference order (chip.rs:268)."""
        self.air.eval(folder)
        if self.perm_width:
            eval_permutation_constraints(
                folder, folder.sends, folder.receives, BATCH_SIZE,
                commit_scope=self.commit_scope, main_width=self.width,
            )
