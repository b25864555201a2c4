"""prover.fold_ops_per_shard: device operations of the profiler's timeline
that started on the card while the proving thread was under one of the
port's `quotient.fold` spans (each chip's eager quotient fold, inside
`body.quotient`), over the `shard` spans proved in the window
(attribution.py). The fold's operations are small and the card is idle
most of the time, so each starts under the span that launched it; one still
queued when its span ends is put down to the span after it. A generated
fold kernel has to cut this count."""

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
    if not shards or not any(s.name == "quotient.fold" for s in spans):
        return None
    return ops_under(run.device, Timeline(spans), "quotient.fold") / len(shards)
