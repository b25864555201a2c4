"""prover.fold_s: host seconds a request spends issuing the eager quotient
fold: the port's own `quotient.fold` spans (one a chip a shard, around
stark/tfolder.py:quotient in ziren_tpu_torch/stark/tprover.py:prove_body's
`body.quotient`), per completed request. The fold issues one to six device
operations a node of the chip's constraint graph, so this is host time spent
launching, not the card's time."""

from ..attribution import reader_attr, window_spans

UNIT = "s/request"
LAYER = "shard prover"
MOVES = "prove_khz"
__getattr__ = reader_attr  # WRAPS: [], and the port's spans recorded in a traced run


def read(run):
    spans = window_spans(run)
    if not spans or not run.done:
        return None
    folds = [s for s in spans if s.name == "quotient.fold"]
    if not folds:
        return None
    return sum(s.t1_ns - s.t0_ns for s in folds) / 1e9 / len(run.done)
