"""Shape system: fixed per-chip trace heights across a batch of shards.

A `Shape` maps chip name -> log2 trace height. `fix_shape(machine, records)`
computes the batch-wide shape (per-chip max height, optionally rounded up to
a cluster grid) and regenerates any trace below its target under the
fixed-height context (machine/layout.py), which routes every height
computation — including each chip's non-zero padding logic — to the target.

Why shapes (reference: crates/core/machine/src/shape/mod.rs:40-165):
  * the device prover jit-caches kernels by trace shape — a stable shape
    set means a finite, warm kernel cache;
  * shard_map data-parallel proving needs identical shapes on every device;
  * recursion lift programs are compiled per proof shape — a finite shape
    set means a finite set of recursion programs and vks.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..machine.layout import fixed_height
from ..trace import carried, span


@dataclass(frozen=True)
class Shape:
    """Ordered (chip name, log_height) pairs, tallest first."""

    heights: tuple

    def log_height(self, name: str) -> int:
        return dict(self.heights)[name]

    def __contains__(self, name):
        return any(n == name for n, _ in self.heights)

    @property
    def names(self):
        return tuple(n for n, _ in self.heights)


class _Traced:
    """What record_traces has done to one record: its synthetic ALU events
    emitted and its dependencies generated (each once: both append to the
    record), and the traces it keeps on the record."""

    __slots__ = ("_synth_done", "_deps_done", "_fixed_traces")

    def __init__(self):
        self._synth_done = self._deps_done = False
        self._fixed_traces = None


def _state(record) -> _Traced:
    st = getattr(record, "_traced", None)
    if st is None:
        st = record._traced = _Traced()
    return st


def emit_synthetic(machine, record):
    st = _state(record)
    if st._synth_done:
        return
    for c in machine.chips:
        if c.air.included(record):
            with span("tracegen.deps", chip=c.name):
                c.air.emit_synthetic(record)
    st._synth_done = True


def record_traces(machine, record, heights=None, keep: bool = False):
    """(chip, trace) pairs for every chip the record includes, in machine
    order: the one place a record's traces are made. The synthetic events
    and the dependencies are emitted once a record. `heights` (chip name ->
    rows) pads each trace to its height under fixed_height; None leaves
    each at its natural height. `keep` keeps the traces on the record (the
    provers then reuse them instead of regenerating): a kept trace is taken
    again where it has the height asked for, and all of them where no
    height is asked for."""
    st = _state(record)
    if heights is None and st._fixed_traces is not None:
        return list(st._fixed_traces)
    held = {c.name: t for c, t in st._fixed_traces or ()}
    with span("tracegen") as sp:
        chips = [c for c in machine.chips if c.air.included(record)]
        sp.set(chips=len(chips))
        emit_synthetic(machine, record)
        if not st._deps_done:
            for c in chips:
                with span("tracegen.deps", chip=c.name):
                    c.air.generate_dependencies(record, record)
            st._deps_done = True
        out = []
        for c in chips:
            want = None if heights is None else heights[c.name]
            t = held.get(c.name)
            if t is None or t.shape[0] != want:
                with fixed_height(want), span("tracegen.trace", chip=c.name):
                    t = c.air.generate_trace(record, record)
                assert want is None or t.shape[0] == want, (c.name, t.shape[0], want)
            out.append((c, t))
    if keep:
        st._fixed_traces = out
    return out


def log_height(chip, n: int, grid: int = 1) -> int:
    """The log2 height of a trace of `n` rows of `chip` (the cost model):
    four rows at least, rounded up to the `grid` log-height cluster unless
    the chip has a preprocessed trace (its height is pinned by the vk)."""
    log_h = (max(int(n), 4) - 1).bit_length()
    return log_h if chip.preprocessed_width else round_up_cluster(log_h, grid)


def estimate_targets(machine, records, grid: int = 1):
    """Batch-wide per-chip target heights WITHOUT generating traces — the
    cost model (reference core/executor/src/cost.rs): every included chip
    reports its real row count via Air.num_rows. Returns None when any
    chip cannot (caller falls back to fix_shape). Under-estimates are
    impossible to miss: trace_height asserts natural <= target."""
    targets: dict = {}
    for record in records:
        emit_synthetic(machine, record)
        for c in machine.chips:
            if not c.air.included(record):
                continue
            n = c.air.num_rows(record)
            if n is None:
                return None
            targets[c.name] = max(targets.get(c.name, 0), 1 << log_height(c, n, grid))
    return targets


def estimate_lde_area(machine, record, log_blowup: int = 1) -> int:
    """Per-AirId prover cost model: total LDE cells (felts) this record's
    shard proof materializes — main + permutation + quotient columns at
    padded height << log_blowup (reference: core/executor/src/cost.rs:225
    estimate_mips_lde_size, executor.rs:161-165). Drives shard-sizing
    decisions: a precompile-dense shard can be far "taller" than its cycle
    count suggests, and SplitOpts.deferred is the knob that re-shards it."""
    emit_synthetic(machine, record)
    total = 0
    for c in machine.chips:
        if not c.air.included(record):
            continue
        n = c.air.num_rows(record)
        if n is None:
            return -1
        h = 1 << log_height(c, n)
        cols = c.width + c.preprocessed_width + 4 * c.perm_width \
            + 4 * c.quotient_degree
        total += (h << log_blowup) * cols
    return total


def generate_fixed(machine, record, targets):
    """Generate this record's traces at the target heights and keep them
    on the record (thread-safe: fixed_height is thread-local)."""
    return record_traces(machine, record, targets, keep=True)


def round_up_cluster(log_h: int, grid: int = 1) -> int:
    """Round a log-height up to the next multiple of `grid` (cluster rule)."""
    return ((log_h + grid - 1) // grid) * grid


def fix_shape(machine, records, grid: int = 1):
    """Generate traces for every record at a common per-chip shape.

    Returns (shape, [per-record [(chip, trace)]]). Records may include
    different chip sets (deferred-event splitting yields cpu-less memory
    shards); each chip's target is the max over the records that include
    it. Chips with a preprocessed trace keep their natural height (it is
    pinned by the vk); others are padded to the per-chip max over the
    batch, rounded up to the `grid` log-height cluster.
    """
    if len(records) > 1:
        # trace generation is numpy-heavy (releases the GIL): shards
        # generate concurrently, mirroring the reference's rayon trace
        # workers (utils/prove.rs TRACE_GEN_WORKERS)
        import os
        from concurrent.futures import ThreadPoolExecutor

        workers = min(len(records), os.cpu_count() or 4)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            per_record = list(
                pool.map(carried(lambda r: record_traces(machine, r, keep=True)), records)
            )
    else:
        per_record = [record_traces(machine, r, keep=True) for r in records]
    machine_order = {c.name: i for i, c in enumerate(machine.chips)}

    targets = {}
    for traces in per_record:
        for c, t in traces:
            log_h = (t.shape[0] - 1).bit_length()
            if c.preprocessed_width == 0:
                log_h = round_up_cluster(log_h, grid)
            targets[c.name] = max(targets.get(c.name, 0), log_h)

    # the traces below their target are made again at it; the provers
    # reuse the ones kept on the records instead of regenerating
    heights = {name: 1 << log_h for name, log_h in targets.items()}
    fixed = [record_traces(machine, r, heights, keep=True) for r in records]

    shape = Shape(
        tuple(
            sorted(
                targets.items(),
                key=lambda kv: (-kv[1], machine_order[kv[0]]),
            )
        )
    )
    return shape, fixed
