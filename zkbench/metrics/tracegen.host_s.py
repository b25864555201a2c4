"""tracegen.host_s: host seconds a request spends generating its shards'
traces (ziren_tpu_torch/stark/tprover.py: _named_traces, which runs every
chip's generate_dependencies and generate_trace on the calling thread on
the SDK's path), per completed request."""

UNIT = "s/request"
LAYER = "host trace generation"
MOVES = "prove_khz"
WRAPS = [("tracegen", "ziren_tpu_torch.stark.tprover:_named_traces")]


def read(run):
    if run.spans is None or not run.done or not run.spans.of("tracegen"):
        return None
    return run.spans.seconds("tracegen") / len(run.done)
