"""prover.upload_s: host seconds a request spends copying its shards'
inputs to the card (the traces, the public values and the transcript): the
port's own `upload` spans (ziren_tpu_torch/stark/tprover.py:dispatch_shard,
and the fused path's buffers), per completed request."""

from ..attribution import reader_attr, window_spans

UNIT = "s/request"
LAYER = "shard prover"
MOVES = "prove_khz"
__getattr__ = reader_attr  # WRAPS: [], and the port's spans recorded in a traced run


def read(run):
    spans = window_spans(run)
    if not spans or not run.done:
        return None
    uploads = [s for s in spans if s.name == "upload"]
    if not uploads:
        return None
    return sum(s.t1_ns - s.t0_ns for s in uploads) / 1e9 / len(run.done)
