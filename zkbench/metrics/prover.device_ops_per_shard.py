"""prover.device_ops_per_shard: device operations (kernels, copies, sets)
of the profiler's timeline that started on the card while the proving
thread was under one of the port's `prove` spans, over the `shard` spans
proved in the window (attribution.py). `prove` ends after its `fetch` has
waited for the card, so an operation still queued when its shard's span
ends is counted all the same; the count also holds the fetch's copies and,
where a key is not yet on the card, its commit."""

from ..attribution import Timeline, ops_under, reader_attr, window_spans

UNIT = "ops/shard"
LAYER = "shard prover"
MOVES = "prove_khz"
__getattr__ = reader_attr  # WRAPS: [], and the port's spans recorded in a traced run


def read(run):
    spans = window_spans(run)
    if not spans or run.device is None or not run.device.events:
        return None
    shards = [s for s in spans if s.name == "shard"]
    if not shards:
        return None
    return ops_under(run.device, Timeline(spans), "prove") / len(shards)
