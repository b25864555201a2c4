"""Prover options with RAM-tiered auto-sizing
(reference: crates/stark/src/opts.rs ZKMProverOpts / ZKMCoreOpts).

The shard size, shard batch size and deferred-split divisor follow the
reference's CPU memory tiers exactly (opts.rs:42-49); every knob has the
same env override (SHARD_SIZE, SHARD_BATCH_SIZE, TRACE_GEN_WORKERS,
ZIREN_SPLIT_MEMORY, ...). Consumers: sdk.ProverClient (default shard
size), executor/split.py SplitOpts.from_env (memory split thresholds),
machine/mips.py prove_program_checkpointed (workers, batch)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _total_ram_gb() -> int:
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        return (pages * page) >> 30
    except (ValueError, OSError):
        return 16


def _memory_opts(ram_gb: int) -> tuple:
    """(log2_shard_size, shard_batch_size, log2_divisor) by RAM tier
    (reference opts.rs get_memory_opts)."""
    if ram_gb < 33:
        return 19, 1, 3
    if ram_gb < 49:
        return 20, 1, 2
    if ram_gb < 65:
        return 21, 1, 3
    if ram_gb < 81:
        return 21, 3, 1
    return 22, 4, 1


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        return default


# reference opts.rs MAX_DEFERRED_SPLIT_THRESHOLD = 1 << 15
MAX_DEFERRED_SPLIT_THRESHOLD = 1 << 15


@dataclass
class SplitOpts:
    """Deferred-event thresholds (reference opts.rs:237-257). `memory` is
    live (executor/split.py standalone memory shards); the per-precompile
    thresholds await the global-scope syscall multiset (ROADMAP)."""

    deferred: int = MAX_DEFERRED_SPLIT_THRESHOLD
    keccak: int = (MAX_DEFERRED_SPLIT_THRESHOLD * 4) // 17
    sha_extend: int = (MAX_DEFERRED_SPLIT_THRESHOLD * 4) // 3
    sha_compress: int = (MAX_DEFERRED_SPLIT_THRESHOLD * 4) // 9
    memory: int = MAX_DEFERRED_SPLIT_THRESHOLD * 4
    combine_memory_threshold: int = 1 << 14

    def scaled(self, log2_divisor: int) -> "SplitOpts":
        d = 1 << log2_divisor
        return SplitOpts(
            deferred=self.deferred // d,
            keccak=self.keccak // d,
            sha_extend=self.sha_extend // d,
            sha_compress=self.sha_compress // d,
            memory=self.memory // d,
            combine_memory_threshold=self.combine_memory_threshold,
        )


@dataclass
class ZirenCoreOpts:
    """(reference ZKMCoreOpts)"""

    shard_size: int = 0
    shard_batch_size: int = 1
    split_opts: SplitOpts = field(default_factory=SplitOpts)
    trace_gen_workers: int = 1
    checkpoints_channel_capacity: int = 128
    records_and_traces_channel_capacity: int = 1

    @staticmethod
    def auto(ram_gb: int | None = None) -> "ZirenCoreOpts":
        ram = _total_ram_gb() if ram_gb is None else ram_gb
        log2_size, batch, log2_div = _memory_opts(ram)
        o = ZirenCoreOpts(
            shard_size=_env_int("SHARD_SIZE", 1 << log2_size),
            shard_batch_size=_env_int("SHARD_BATCH_SIZE", batch),
            split_opts=SplitOpts().scaled(log2_div),
            trace_gen_workers=_env_int(
                "TRACE_GEN_WORKERS", min(os.cpu_count() or 1, 4)
            ),
            checkpoints_channel_capacity=_env_int(
                "CHECKPOINTS_CHANNEL_CAPACITY", 128
            ),
            records_and_traces_channel_capacity=_env_int(
                "RECORDS_AND_TRACES_CHANNEL_CAPACITY", 1
            ),
        )
        o.split_opts.memory = _env_int("ZIREN_SPLIT_MEMORY", o.split_opts.memory)
        o.split_opts.deferred = _env_int(
            "ZIREN_SPLIT_DEFERRED", o.split_opts.deferred)
        o.split_opts.combine_memory_threshold = _env_int(
            "ZIREN_COMBINE_MEMORY_THRESHOLD",
            o.split_opts.combine_memory_threshold,
        )
        return o

    @staticmethod
    def recursion() -> "ZirenCoreOpts":
        o = ZirenCoreOpts.auto()
        o.shard_batch_size = 2
        o.trace_gen_workers = _env_int(
            "ZIREN_RECURSION_WORKERS", min(os.cpu_count() or 1, 4)
        )
        return o


@dataclass
class ZirenProverOpts:
    """(reference ZKMProverOpts)"""

    core_opts: ZirenCoreOpts = field(default_factory=ZirenCoreOpts.auto)
    recursion_opts: ZirenCoreOpts = field(
        default_factory=ZirenCoreOpts.recursion
    )

    @staticmethod
    def auto(ram_gb: int | None = None) -> "ZirenProverOpts":
        return ZirenProverOpts(
            core_opts=ZirenCoreOpts.auto(ram_gb),
            recursion_opts=ZirenCoreOpts.recursion(),
        )
