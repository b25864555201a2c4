"""tracegen.deps_s: host seconds a request spends making its chips'
dependency and synthetic events, the first half of trace generation: the
port's own `tracegen.deps` spans (for each chip, one around emit_synthetic
and one around generate_dependencies: ziren_tpu_torch/stark/tprover.py:
_named_traces, stark/shape.py), per completed request."""

from ..attribution import reader_attr, window_spans

UNIT = "s/request"
LAYER = "host trace generation"
MOVES = "prove_khz"
__getattr__ = reader_attr  # WRAPS: [], and the port's spans recorded in a traced run


def read(run):
    spans = window_spans(run)
    if not spans or not run.done:
        return None
    deps = [s for s in spans if s.name == "tracegen.deps"]
    if not deps:
        return None
    return sum(s.t1_ns - s.t0_ns for s in deps) / 1e9 / len(run.done)
