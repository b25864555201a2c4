"""prover.issue_s: host seconds a request spends issuing device work in the
shard prover: StarkMachine.prove's own `stats=` dispatch seconds (its call
seconds on the fused path), less the trace generation that runs inside the
dispatches (tprover.dispatch_shard -> _named_traces), per completed
request."""

UNIT = "s/request"
LAYER = "shard prover"
MOVES = "prove_khz"
WRAPS = [("prove", "ziren_tpu_torch.stark.machine:StarkMachine.prove"),
         ("issue", "ziren_tpu_torch.stark.machine:dispatch_shard"),
         ("tracegen", "ziren_tpu_torch.stark.tprover:_named_traces")]


def read(run):
    if run.spans is None or not run.done or not run.spans.stats:
        return None
    issued = sum(sum(st.get("dispatch_s", st.get("call_s", []))) for st in run.spans.stats)
    issues = run.spans.of("issue")
    inside = sum(t1 - t0 for t0, t1 in run.spans.of("tracegen")
                 if any(s <= t0 and t1 <= e for s, e in issues)) / 1e9
    return (issued - inside) / len(run.done)
